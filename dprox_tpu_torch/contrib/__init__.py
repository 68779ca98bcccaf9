"""Applications built on the port: CS-MRI (``csmri``), deraining
(``derain``) and energy-planning LPs (``energy_system``)."""
from . import csmri, derain
