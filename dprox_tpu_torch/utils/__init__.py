from . import fft, imaging, init, metrics, misc
from .init import demosaic_bilinear, demosaic_from_mosaiced
from .misc import expand_to_bchw, resolve_device, to_tensor
