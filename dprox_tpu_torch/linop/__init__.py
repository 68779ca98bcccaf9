from .base import (LinOp, Variable, Constant, Placeholder, scale, split, sum, vstack,
                   cast_to_const)
from .ops import (BlackBox, LinOpFactory, conv, conv_doe, grad, mosaic, mul_color,
                  mul_elementwise)
from .constraints import matmul, equality, less
from .evaluate import eval, adjoint, gram, validate, est_norm
from .visualize import to_dot, to_text, visualize
from ..utils.misc import resolve_device

# Compatibility names of the JAX package (dprox_tpu/linop/__init__.py).
# Shared subexpressions need no copy nodes under functional evaluation, so
# ``copy`` is the identity.


def est_CompGraph_norm(op, tol: float = 1e-3, try_fast_norm: bool = False,
                       shape=None, device="cuda", **kwargs):
    """``est_norm`` under the reference's name and signature, on
    ``device`` (moving the operator's data there); ``tol`` and
    ``try_fast_norm`` are accepted and unused (the power iteration runs its
    fixed number of iterations)."""
    del tol, try_fast_norm
    op.to(resolve_device(device))
    if shape is not None:
        kwargs["shape"] = shape
    return est_norm(op, **kwargs)


def copy(op):
    """Identity: shared subexpressions need no copy nodes."""
    return op
