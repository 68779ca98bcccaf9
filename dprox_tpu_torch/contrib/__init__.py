"""Applications built on the port: CS-MRI (``csmri``), deraining
(``derain``), energy-planning LPs (``energy_system``) and the DOE optics
co-design (``optic``); ``restoration`` is ``utils.imaging``, under the
JAX package's name."""
from . import csmri, derain, energy_system, optic
from ..utils import imaging as restoration
from ..utils.imaging import (blurring, downsampling, fspecial_gaussian, masks_CFA_Bayer, mosaicing,
                             point_spread_function, sample)
from ..utils.misc import to_ndarray

# one mosaicing serves numpy arrays and tensors
mosaicing_np = mosaicing
