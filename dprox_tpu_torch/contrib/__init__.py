"""Applications built on the port: CS-MRI (``csmri``) and energy-planning LPs
(``energy_system``)."""
from . import csmri
