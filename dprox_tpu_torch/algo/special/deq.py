"""Deep-equilibrium solver specialization.

Counterpart of dprox_tpu/algo/special/deq.py. One whole solver iteration
over the packed state is the fixed-point map z = f(theta, z); the
equilibrium is differentiable through the implicit function theorem, as a
``torch.autograd.Function``:

    forward:  z* = anderson(z -> f(theta, z))                 (no grad)
    backward: build f(theta, z*) once, keep its graph;
              y* = anderson(y -> y^T df/dz + g) on that graph;
              g_theta = y*^T df/dtheta from the same graph.

Gradients are exact at the equilibrium whatever the forward iteration
count; z0 gets none (the fixed point does not depend on it). theta's
tensors (rho, the lams, ``deq_r`` / ``deq_l`` through them, and the
params dict with a denoiser's weights) are the Function's inputs, so
autograd sees every one of them; f must not close over a tensor that
needs a gradient.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..base import Algorithm, params_to
from .fixed_point import FIXED_POINT_SOLVERS

_N_CONFIG = 8  # forward's arguments before theta's tensors


class _DEQFixedPoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, rebuild, z0, f_thres, b_thres, solver, stats, precision, *tensors):
        engine = FIXED_POINT_SOLVERS[solver]
        theta = rebuild(tensors)
        fwd = {}
        with precision():
            z = engine(lambda z: f(theta, z), z0, threshold=f_thres, stats=fwd)
        if stats is not None:
            stats["forward"] = fwd
        ctx.save_for_backward(z, *tensors)
        ctx.config = (f, rebuild, b_thres, engine, stats, precision)
        return z

    @staticmethod
    def backward(ctx, g):
        f, rebuild, b_thres, engine, stats, precision = ctx.config
        z_star, *tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[_N_CONFIG:]
        with torch.enable_grad(), precision():
            z = z_star.detach().requires_grad_()
            theta = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            fz = f(rebuild(theta), z)

        def adjoint(y):
            (vjp,) = torch.autograd.grad(fz, z, y, retain_graph=True, allow_unused=True)
            return g if vjp is None else vjp + g

        bwd = {}
        with precision():
            y = engine(adjoint, torch.zeros_like(g), threshold=b_thres, stats=bwd)
        if stats is not None:
            stats["backward"] = bwd
        wrt = [t for t, n in zip(theta, need) if n]
        grads = iter(torch.autograd.grad(fz, wrt, y, allow_unused=True) if wrt else ())
        return (None,) * _N_CONFIG + tuple(next(grads) if n else None for n in need)


def deq_fixed_point(f: Callable, theta, z0, f_thres: int = 40, b_thres: int = 40,
                    solver: str = "anderson", stats: Optional[dict] = None,
                    precision: Callable = contextlib.nullcontext):
    """Differentiable fixed point of z = f(theta, z). ``theta``: nested
    tuples, lists and dicts whose tensors get gradients. ``stats``, where
    given, gets the engine's ``"forward"`` stats, and ``"backward"`` once
    the backward has run; ``precision``: a context manager factory entered
    around every evaluation of f, forward and backward."""
    leaves, spec = tree_flatten(theta)
    where = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]

    def rebuild(tensors):
        filled = list(leaves)
        for i, t in zip(where, tensors):
            filled[i] = t
        return tree_unflatten(filled, spec)

    return _DEQFixedPoint.apply(f, rebuild, z0, f_thres, b_thres, solver, stats, precision,
                                *[leaves[i] for i in where])


@contextlib.contextmanager
def _highest():
    """float32 convolutions and matmuls without TF32, the flags restored
    afterwards."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


_PRECISION = {"highest": _highest, None: contextlib.nullcontext}


class DEQSolver:
    """A compiled Algorithm as a deep-equilibrium model: one whole solver
    iteration is the fixed-point map over the packed state. Learnable
    global (rho, lam) multipliers travel in ``params`` as ``deq_r`` /
    ``deq_l``; a complex packed state (CS-MRI) runs the engine on its real
    view [Re z; Im z] (stacked along the last axis).

    ``precision="highest"`` turns TF32 off for cuDNN and matmuls inside
    the solve and its backward: equilibrium solving needs the residual
    f(z) - z finer than its own size (the JAX package measured a 1.6 dB
    divergence with f at reduced precision). None inherits the caller's
    flags.

    ``anneal=L``: L equilibria, each conditioned on its level of the
    (rho, lam) schedules (of length >= L) and warm-started from the one
    before; ``f_thres`` applies per level. The backward reaches the last
    level only (each warm start is a constant), so anneal at inference.
    """

    def __init__(self, solver: Algorithm, learned_params: bool = False, f_thres: int = 40,
                 b_thres: int = 40, solver_type: str = "anderson", rhos=None, lams=None,
                 precision: Optional[str] = "highest", anneal: int = 1):
        if precision not in _PRECISION:
            raise ValueError(f"precision must be 'highest' or None, got {precision!r}")
        self.internal = solver
        self.learned_params = learned_params
        self.f_thres = f_thres
        self.b_thres = b_thres
        self.solver_type = solver_type
        self.rhos = rhos
        self.lams = lams
        self.precision = precision
        self.anneal = max(1, int(anneal))

    @property
    def device(self):
        return self.internal.device

    def init_params(self):
        if not self.learned_params:
            return {}
        return {"deq_r": torch.tensor(1.0, device=self.device),
                "deq_l": torch.tensor(1.0, device=self.device)}

    def _truncate(self, v):
        """The first ``anneal`` levels of a longer schedule."""
        try:
            return v[:self.anneal] if len(v) > self.anneal else v
        except TypeError:
            return v

    def solve(self, x0=None, rhos=None, lams=None, params: Optional[dict] = None,
              real_output: bool = False, stats: Optional[list] = None, **kwargs):
        """The equilibrium's x (its real part with ``real_output``).
        ``stats``, where given, gets one dict per level, filled as
        ``deq_fixed_point`` fills it."""
        solver = self.internal
        x0 = solver._prepare_x0(x0)
        params = params_to(dict(params or {}), self.device)
        rhos = self.rhos if rhos is None else rhos
        lams = self.lams if lams is None else lams
        if self.anneal > 1:
            rhos = self._truncate(rhos)
            if isinstance(lams, dict):
                lams = {k: self._truncate(v) for k, v in lams.items()}
            elif isinstance(lams, (list, tuple)):
                lams = type(lams)(self._truncate(v) for v in lams)
            else:
                lams = self._truncate(lams)
        rhos, lam_list = solver.defaults(rhos, lams, self.anneal)
        if self.learned_params:
            one = torch.ones((), device=self.device)
            rhos = rhos * params.get("deq_r", one)
            lam_list = [l * params.get("deq_l", one) for l in lam_list]
        precision = _PRECISION[self.precision]
        with precision():
            state0 = solver.initialize(x0, params)
            z0 = solver.pack(state0)
            aux = solver.prepare_aux(x0, params)
            if z0.is_complex():
                cdtype = z0.dtype

                def c2r(z):
                    return torch.cat([z.real, z.imag], dim=-1)

                def r2c(zr):
                    half = zr.shape[-1] // 2
                    return torch.complex(zr[..., :half], zr[..., half:]).to(cdtype)
            else:
                c2r = r2c = lambda z: z  # noqa: E731

            def f(theta, z):
                rho, lam, p = theta
                state = solver._iter(tuple(solver.unpack(r2c(z))), rho, list(lam), 0, p, aux)
                return c2r(solver.pack(state))

            z = c2r(z0)
            for level in range(self.anneal):
                level_stats = {} if stats is not None else None
                z = deq_fixed_point(f, (rhos[level], tuple(l[level] for l in lam_list), params),
                                    z, self.f_thres, self.b_thres, self.solver_type,
                                    level_stats, precision)
                if stats is not None:
                    stats.append(level_stats)
            out = solver.unpack(r2c(z))[0]
        return out.real if real_output else out

    def load(self, state):
        self.rhos = state.get("rhos")
        self.lams = state.get("lams")


def train_deq(solver: DEQSolver, step_fn=None, **kwargs):
    """Supervised DEQ training: the shared loop of ``training.py``."""
    from .training import train_supervised

    return train_supervised(step_fn=step_fn, **kwargs)
