from .csmri import csmri
from .sr import sisr, misr
from .cs import compress_sensing
from .spi import spi
from .pr import phase_ret, cdp_forward, cdp_backward
