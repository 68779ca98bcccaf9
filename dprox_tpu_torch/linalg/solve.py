"""Differentiable linear solve with implicit (analytic) gradients.

Counterpart of dprox_tpu/linalg/solve.py. The implicit-function-theorem
backward pass is a ``torch.autograd.Function``:

    forward:  x* = solver(A(theta, .), b)
    backward: gb = solver(A(theta, .)^T, g)            (matrix-free transpose)
              gtheta = vjp_theta(-A(theta, x*))(gb)

so gradients are exact at the solution whatever the solver's iteration
count, and the solver loop is never differentiated through. The backward
runs inside ``span("dprox.vjp")`` and counts in ``ops.vjps``
(utils/profiling.py). With ``use_analytic_grad=False`` the solve is
instead ``cg_unrolled``, a fixed number of CG iterations that autograd
differentiates step by step (on the card through ``bdot``'s own
backward).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.profiling import vjp_span
from .solvers import SOLVERS, cg_unrolled, pcg

Array = torch.Tensor


@dataclasses.dataclass
class LinearSolveConfig:
    rtol: float = 1e-6
    max_iters: int = 100
    verbose: bool = False
    solver_type: str = "cg"
    solver_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_analytic_grad: bool = True
    symmetric: bool = True  # KtK systems are SPD; skips building a transpose


def _run_solver(config: LinearSolveConfig, A: Callable, b: Array, x0=None, Minv=None,
                structured=None, theta=None) -> Array:
    if structured is not None:
        return structured(theta, b, x0=x0, rtol=config.rtol, max_iters=config.max_iters)
    kwargs = dict(config.solver_kwargs)
    if x0 is not None:
        kwargs["x0"] = x0
    if Minv is not None:
        kwargs["Minv"] = Minv
    return SOLVERS[config.solver_type](A, b, rtol=config.rtol, max_iters=config.max_iters,
                                       **kwargs)


def _flatten(tree):
    """Tensor leaves of a nest of tuples, lists and dicts, and a function
    that rebuilds the nest around new leaves (other leaves stay put)."""
    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return ("leaf", len(leaves) - 1)
        if isinstance(node, (tuple, list)):
            return (type(node), [walk(n) for n in node])
        if isinstance(node, dict):
            return (dict, {k: walk(v) for k, v in node.items()})
        return ("static", node)

    spec = walk(tree)

    def rebuild(new_leaves, node=spec):
        kind, payload = node
        if kind == "leaf":
            return new_leaves[payload]
        if kind == "static":
            return payload
        if kind is dict:
            return {k: rebuild(new_leaves, v) for k, v in payload.items()}
        return kind(rebuild(new_leaves, n) for n in payload)

    return leaves, rebuild


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, config, A_fn, Minv_fn, structured, rebuild, b, x0, *leaves):
        theta = rebuild(leaves)
        Minv = None if Minv_fn is None else (lambda r: Minv_fn(theta, r))
        x = _run_solver(config, lambda v: A_fn(theta, v), b, x0, Minv, structured, theta)
        ctx.save_for_backward(x, *leaves)
        ctx.config, ctx.A_fn, ctx.Minv_fn, ctx.rebuild = config, A_fn, Minv_fn, rebuild
        ctx.structured = structured
        return x

    @staticmethod
    def backward(ctx, g):
        with vjp_span():
            x, *leaves = ctx.saved_tensors
            config, A_fn, Minv_fn, rebuild = ctx.config, ctx.A_fn, ctx.Minv_fn, ctx.rebuild
            theta = rebuild(leaves)
            if config.symmetric:
                AT = lambda v: A_fn(theta, v)
            else:
                def AT(v):  # A is linear: its VJP at any point is the transpose
                    with torch.enable_grad():
                        z = torch.zeros_like(v, requires_grad=True)
                        (out,) = torch.autograd.grad(A_fn(theta, z), z, v)
                    return out
            # the same SPD preconditioner accelerates the transpose solve
            Minv = None if Minv_fn is None else (lambda r: Minv_fn(theta, r))
            gb = _run_solver(config, AT, g.contiguous(), Minv=Minv,
                             structured=ctx.structured if config.symmetric else None, theta=theta)
            # dtheta: VJP of theta -> -A(theta, x*) applied to gb
            gleaves = [None] * len(leaves)
            wanted = [i for i in range(len(leaves))
                      if ctx.needs_input_grad[7 + i] and leaves[i].is_floating_point()]
            if wanted:
                with torch.enable_grad():
                    live = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(leaves)]
                    out = A_fn(rebuild(live), x)
                    grads = torch.autograd.grad(out, [live[i] for i in wanted], gb,
                                                allow_unused=True)
                for i, gt in zip(wanted, grads):
                    gleaves[i] = None if gt is None else -gt
            # the converged solution does not depend on the warm start: no grad for x0
            return (None, None, None, None, None, gb, None, *gleaves)


def linear_solve(A_fn: Callable, b: Array, theta=None,
                 config: Optional[LinearSolveConfig] = None,
                 x0: Optional[Array] = None,
                 Minv_fn: Optional[Callable] = None,
                 structured: Optional[Callable] = None) -> Array:
    """Solve A(theta) x = b, differentiable w.r.t. ``b`` and the tensors
    in ``theta``.

    ``A_fn(theta, v)`` is the matrix-free matvec; ``theta`` is any nest of
    tuples, lists and dicts holding the parameters that appear inside A
    (rho, learned operator weights, ...). ``Minv_fn(theta, r)`` is an
    optional preconditioner. With ``config.use_analytic_grad`` the backward
    pass uses the implicit formula and ``x0`` (a warm start) gets no
    gradient: at the solver tolerance the solution does not depend on the
    initialization. Otherwise the solve is ``cg_unrolled`` with the
    config's ``rtol`` and ``max_iters``, unpreconditioned (``Minv_fn`` is
    not used), and autograd differentiates through every iteration, as
    the JAX package does.

    ``structured(theta, b, x0=, rtol=, max_iters=)``, where given, is a
    solve of the same system by the configured solver that knows A's
    structure (``linalg.structured.mosaic_conv_pcg``): the implicit path
    runs it in place of ``config.solver_type``, forward and, for a
    symmetric A, in the backward's transposed solve. The VJP with respect
    to ``theta`` still differentiates ``A_fn``.
    """
    config = config or LinearSolveConfig()
    theta = () if theta is None else theta
    if not config.use_analytic_grad:
        return cg_unrolled(lambda v: A_fn(theta, v), b, x0=x0, rtol=config.rtol,
                           max_iters=config.max_iters)
    leaves, rebuild = _flatten(theta)
    return _ImplicitSolve.apply(config, A_fn, Minv_fn, structured, rebuild, b, x0, *leaves)


def pcg_solve(A_fn: Callable, b: Array, theta=None, Minv=None, x0=None,
              rtol: float = 1e-6, max_iters: int = 100) -> Array:
    """Convenience preconditioned solve, not differentiable."""
    return pcg(lambda v: A_fn(theta, v), b, Minv=Minv, x0=x0, rtol=rtol,
               max_iters=max_iters)
