from . import fft, imaging, init, metrics, misc
from .fft import fft2_center, ifft2_center, psf2otf, psf2otf_traced
from .imaging import downsampling
from .init import (demosaic_bilinear, demosaic_ea, demosaic_from_mosaiced, demosaic_malvar,
                   shift_pixel)
from .metrics import ergas, mpsnr, mpsnr_max, mse, mssim, psnr, sam, ssim
from .misc import array, expand_to_bchw, resolve_device, to_tensor
