"""DOE optics co-design: the diffractive optic's PSF simulation
(``RGBCollimator``, the hybrid ``HybridRGBCollimator``), the Fresnel
baseline, image and PSF utilities; with the JAX package's re-exports."""
from . import common
from .common import get_one_phase_shift_thickness
from .doe_model import (DOEModelConfig, FresnelPropagator, HeightMap, RGBCollimator,
                        area_downsampling, build_baseline_height_map_sqrt, build_baseline_profile,
                        build_doe_model, get_coordinate, img_psf_conv)
from .doe_model_hybrid import (HybridDOEModelConfig, HybridRGBCollimator, build_hybrid_doe_model,
                               sellmeier_fused_silica)
from .utils import (Dataset, SingleImageDataset, center_crop, load_sample_img, normalize_psf,
                    normalize_psf2, plot, plot3d, sanity_check, subplot)
from ...linop import Variable, conv_doe
from ...models import optics_unet as unet
from ...models.optics_unet import OpticsUNet
from ...utils.fft import psf2otf
from ...utils.misc import outlier_correct

U_Net = OpticsUNet  # the reference's name (dprox.contrib.optic.U_Net)
