from . import checkpoint, fft, hub, imaging, init, io, metrics, misc, profiling
from .checkpoint import load_pytree, save_pytree
from .fft import fft2_center, ifft2_center, psf2otf, psf2otf_traced
from .hub import download_dataset, load_checkpoint, load_path
from .imaging import (bayer_mask, blurring, downsampling, fspecial_gaussian, masks_CFA_Bayer,
                      mosaicing, point_spread_function, resize_cubic, sample)
from .init import (demosaic_bilinear, demosaic_ea, demosaic_from_mosaiced, demosaic_malvar,
                   shift_pixel)
from .io import filter_ckpt, imread, imread_rgb, imshow, is_image_file, list_image_files
from .metrics import ergas, mpsnr, mpsnr_max, mse, mssim, psnr, sam, ssim
from .misc import (array, crop_center_region, debatchify, expand_to_bchw, outlier_correct,
                   resolve_device, safe_sqrt, seed_everything, to_ndarray, to_tensor)
from .profiling import IterationTimer, Timer, trace

# the JAX package's names: fft2 / ifft2 are the centred orthonormal
# transforms; hf and huggingface the hub
fft2 = fft2_center
ifft2 = ifft2_center
hf = huggingface = hub
