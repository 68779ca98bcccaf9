"""Operator equilibration (diagonal rescaling of K).

Counterpart of dprox_tpu/algo/equil.py: stochastic left/right diagonal
equilibration from sampled matvecs. The Rademacher probes come from an
explicit ``torch.Generator`` in place of the JAX package's ``jax.random``
key (seed 0 when none is given), so the draws differ from JAX's; the
scalings agree in distribution, not in value.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..linop.base import LinOp
from ..linop.evaluate import adjoint as lin_adjoint, eval as lin_eval
from ..utils.misc import resolve_device


def _rademacher(shape, generator, device):
    s = torch.randint(0, 2, tuple(shape), generator=generator, dtype=torch.int8)
    return (2.0 * s - 1.0).to(device=device, dtype=torch.float32)


def stochastic_equilibrate(op: LinOp, shape, params=None, iters: int = 20,
                           samples: int = 4, generator: Optional[torch.Generator] = None,
                           alpha: float = 1.0, device="cuda"):
    """Scalings d (input space) and e (output space) such that
    diag(e) K diag(d) is roughly norm-balanced: each iteration estimates
    |K| row and column sums with Rademacher probes through K and K^T.
    Runs on ``device`` (moving the operator's data there)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = resolve_device(device)
    op.to(dev)
    Kx = lin_eval(op, torch.ones(tuple(shape), dtype=torch.float32, device=dev), params)
    out_shape = Kx.shape
    d = torch.ones(tuple(shape), dtype=torch.float32, device=dev)
    e = torch.ones(out_shape, dtype=torch.float32, device=dev)
    for _ in range(iters):
        acc_r = 0.0
        for _ in range(samples):  # row magnitudes: E_s |K (d*s)|
            acc_r = acc_r + torch.abs(lin_eval(op, d * _rademacher(shape, g, dev), params))
        r = acc_r / samples
        e = e / torch.sqrt(torch.maximum(r * e, r.new_tensor(1e-8)))
        acc_c = 0.0
        for _ in range(samples):  # column magnitudes through the adjoint
            acc_c = acc_c + torch.abs(lin_adjoint(op, e * _rademacher(out_shape, g, dev), params))
        c = acc_c / samples
        d = d / torch.sqrt(torch.maximum(c * d, c.new_tensor(1e-8)))
    return d, e
