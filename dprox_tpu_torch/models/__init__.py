from .ffdnet import FFDNet
from .tv import tv_denoising3d_chw, tv_denoising_chw
