from .convert import fold_batchnorm, load_torch_state_dict
from .dgu import DGUDenoiser
from .dncnn import DnCNN, FDnCNN, IRCNN
from .drunet import UNetRes
from .ffdnet import FFDNet, FFDNet3D
from .optics_unet import OpticsUNet, pad_to_ratio_of_32, unpad_from_ratio_of_32
from .qrnn import GRUnet, QRNNREDC3D
from .tv import tv_denoising, tv_denoising3d, tv_denoising3d_chw, tv_denoising_chw
from .unet import UNet
