from .base import LinOp, Variable, Constant, Placeholder, scale, sum, vstack
from .ops import conv, grad, mosaic, mul_elementwise
from .evaluate import eval, adjoint, gram, validate, est_norm
