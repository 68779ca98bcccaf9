"""Algorithm base: runs proxfn lists as a Python iteration loop.

Counterpart of dprox_tpu/algo/base.py (``solve``,
``solve_with_residuals``, ``_schedule``). The JAX package scans a pure
step function under jit; here the same step

    state_{k+1} = _iter(state_k, rho_k, lam_k, step_k, params, aux)

runs eagerly in a Python loop. The (rho, lam) schedules are moved to the
solver's device once per solve and indexed there, so the loop never
copies a scalar between host and device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Any

import numpy as np
import torch

from ..linop.base import Params
from ..proxfn.base import ProxFn
from ..utils.misc import resolve_device, to_tensor

Array = torch.Tensor


class IterAux(NamedTuple):
    """Iteration-invariant values hoisted out of the solver loop:
    per-psi-fn offsets and the least-squares ``prepare`` dict."""

    offsets: Any
    lsq: Any = None


def _isscalar(x):
    return np.isscalar(x) or getattr(x, "ndim", None) == 0


def _schedule(val, max_iter: int, device) -> Array:
    """Normalize a scalar/sequence to a [max_iter] (or [max_iter, B]) float32
    tensor on ``device``, iteration axis leading."""
    if _isscalar(val):
        return torch.full((max_iter,), float(val), dtype=torch.float32, device=device)
    if isinstance(val, torch.Tensor):
        arr = val.to(device=device, dtype=torch.float32)
    else:
        arr = torch.as_tensor(np.asarray(val, np.float32), device=device)
    if arr.ndim == 1:
        if arr.shape[0] != max_iter:
            raise ValueError(f"schedule length {arr.shape[0]} != max_iter {max_iter}")
        return arr
    if arr.shape[-1] == max_iter:  # [B, max_iter] -> [max_iter, B]
        return torch.movedim(arr, -1, 0)
    return arr


class Algorithm:
    """Base proximal algorithm; its data lives on ``device``."""

    @classmethod
    def partition(cls, prox_fns: List[ProxFn]):
        raise NotImplementedError

    def __init__(self, psi_fns: List[ProxFn], omega_fns: List[ProxFn], device="cuda"):
        self.device = resolve_device(device)
        self.psi_fns = [fn.to(self.device) for fn in psi_fns]
        self.omega_fns = [fn.to(self.device) for fn in omega_fns]

    # ------------------------------------------------------------------ #
    # To be implemented by concrete algorithms
    # ------------------------------------------------------------------ #

    def initialize(self, x0: Array, params: Optional[Params]):
        raise NotImplementedError

    def _iter(self, state, rho, lam: Sequence[Array], step, params, aux):
        raise NotImplementedError

    def residuals(self, prev_state, state, rho, params):
        """Relative primal/dual residual norms for one iteration, or None
        if the algorithm has no consensus splitting."""
        return None

    # ------------------------------------------------------------------ #
    # Shared machinery
    # ------------------------------------------------------------------ #

    def K_forward(self, x: Array, params: Optional[Params]):
        """Linear images [K_i x] for each psi fn."""
        return [fn.dag_forward(x, params) for fn in self.psi_fns]

    def prepare_aux(self, x0: Array, params: Optional[Params]) -> IterAux:
        """Everything iteration-invariant, computed once per solve."""
        var_shapes = self._var_shapes(x0)
        offsets = tuple(fn.offset(var_shapes, params) for fn in self.psi_fns)
        lsq = None
        ls = getattr(self, "least_square", None)
        if ls is not None and hasattr(ls, "prepare"):
            lsq = ls.prepare(var_shapes, params, ref_shape=tuple(x0.shape))
        return IterAux(offsets=offsets, lsq=lsq)

    def _var_shapes(self, x0: Array):
        names = set()
        for fn in self.psi_fns + self.omega_fns:
            for v in fn.linop.variables:
                names.add(v.name)
        if not names:
            names = {"x"}
        return {n: tuple(x0.shape) for n in names}

    def defaults(self, rhos, lams, max_iter: int):
        """(rho schedule, one lam schedule per psi fn) on the device; rho
        defaults to 1.0 and lam to 0.02. ``lams`` is one value or schedule
        shared by every psi fn, a dict keyed by the psi fn objects (0.02
        for a missing fn), or a list of one value or schedule per psi fn.
        A schedule is [max_iter], or [B, max_iter] for one per batch
        element."""
        rhos = _schedule(1.0 if rhos is None else rhos, max_iter, self.device)
        if lams is None:
            lams = 0.02
        if isinstance(lams, dict):
            lam_list = [_schedule(lams.get(fn, 0.02), max_iter, self.device)
                        for fn in self.psi_fns]
        elif (isinstance(lams, (list, tuple)) and len(lams) == len(self.psi_fns)
              and not _isscalar(lams[0])):
            lam_list = [_schedule(v, max_iter, self.device) for v in lams]
        else:
            lam = _schedule(lams, max_iter, self.device)
            lam_list = [lam for _ in self.psi_fns]
        return rhos, tuple(lam_list)

    def _prepare_x0(self, x0):
        """x0 batched on the device, complex64 if complex (a k-space
        state), else float32. A complex numpy x0 gets leading axes up to
        4-D, as the JAX package gives it."""
        if isinstance(x0, np.ndarray) and np.iscomplexobj(x0):
            if x0.ndim == 3 and x0.shape[2] in (1, 3):
                x0 = x0.transpose(2, 0, 1)
            while x0.ndim < 4:
                x0 = x0[None]
        x0 = to_tensor(x0, batch=True, device=self.device)
        return x0.to(torch.complex64 if x0.is_complex() else torch.float32)

    @staticmethod
    def _restore_shape(out, orig_shape):
        """Undo ``_prepare_x0``'s batching so the solution comes back in
        the caller's layout (rank prepend and HWC -> BCHW)."""
        if orig_shape is None:
            return out
        if tuple(out.shape) == (1,) + orig_shape:
            return out[0]
        if (len(orig_shape) == 3 and orig_shape[2] in (1, 3)
                and tuple(out.shape) == (1, orig_shape[2], orig_shape[0], orig_shape[1])):
            return out[0].permute(1, 2, 0)
        return out

    def _run(self, x0, rhos, lams, max_iter, params, on_step=None):
        orig_shape = tuple(x0.shape) if hasattr(x0, "shape") else None
        x0 = self._prepare_x0(x0)
        rhos, lam_list = self.defaults(rhos, lams, max_iter)
        # placeholder values go to the solver's device once, not per iteration
        params = {k: to_tensor(v, device=self.device)
                  if isinstance(v, (np.ndarray, torch.Tensor)) else v
                  for k, v in (params or {}).items()}
        state = self.initialize(x0, params)
        aux = self.prepare_aux(x0, params)
        for it in range(max_iter):
            rho = rhos[it]
            lam = [l[it] for l in lam_list]
            p_it = dict(params, __step__=it)
            new = self._iter(state, rho, lam, it, p_it, aux)
            if on_step is not None:
                on_step(it, state, new, rho, lam, p_it)
            state = new
        return state, orig_shape

    # ------------------------------------------------------------------ #
    # Solve
    # ------------------------------------------------------------------ #

    def solve(self, x0=None, rhos=None, lams=None, max_iter: int = 24,
              params: Optional[Params] = None, callback: Optional[Callable] = None,
              real_output: bool = False):
        """Run the solver; returns x* (its real part with ``real_output``,
        for a complex state). ``callback(iter=, state=, rho=, lam=)`` runs
        after every iteration."""
        def on_step(it, prev, new, rho, lam, p_it):
            callback(iter=it, state=new, rho=rho, lam=lam)

        state, orig_shape = self._run(x0, rhos, lams, max_iter, params,
                                      on_step if callback is not None else None)
        out = self._restore_shape(state[0], orig_shape)
        return out.real if real_output else out

    def solve_with_residuals(self, x0=None, rhos=None, lams=None,
                             max_iter: int = 24, params: Optional[Params] = None,
                             real_output: bool = True):
        """Solve and record relative primal/dual residual norms per
        iteration; returns ``(x, {'r_primal': [T], 'r_dual': [T]})`` with
        the residuals as device tensors (x real by default, as in the JAX
        package)."""
        res: Dict[str, list] = {"r_primal": [], "r_dual": []}

        def on_step(it, prev, new, rho, lam, p_it):
            r = self.residuals(prev, new, rho, p_it)
            if r is None:
                raise NotImplementedError(
                    f"{type(self).__name__} does not track primal/dual residuals "
                    "(no consensus splitting)")
            for k in res:
                res[k].append(r[k])

        state, orig_shape = self._run(x0, rhos, lams, max_iter, params, on_step)
        out = self._restore_shape(state[0], orig_shape)
        return (out.real if real_output else out,
                {k: torch.stack(v) if v else torch.zeros(0) for k, v in res.items()})
