"""Algorithm base: runs proxfn lists as a Python iteration loop.

Counterpart of dprox_tpu/algo/base.py (``solve``, ``solve_with_residuals``,
``solve_until``, ``iters``, ``pack`` / ``unpack``, ``_schedule``). The JAX
package scans a pure step function under jit; here the same step

    state_{k+1} = _iter(state_k, rho_k, lam_k, step_k, params, aux)

runs eagerly in a Python loop. The (rho, lam) schedules are moved to the
solver's device once per solve and indexed there, so the loop never
copies a scalar between host and device (``solve_until`` reads its two
residuals once an iteration, its stop test).

State is a tuple (``(x, v_tuple, u_tuple)`` for ADMM); ``pack`` /
``unpack`` flatten it along the channel axis for the RL tuner and the
DEQ's fixed-point engine.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Any

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..linop.base import Params
from ..proxfn.base import ProxFn
from ..utils.misc import resolve_device, to_tensor

Array = torch.Tensor


_COMPLEX_TAG = "__complex_pair__"


def encode_complex(tree):
    """Replace complex tensors (at any depth of nested dicts, lists and
    tuples) by ``{re, im}`` float pairs: the JAX package's boundary format.
    No torch path needs it; it exists so that data written for the JAX
    package's boundaries reads the same here."""
    if isinstance(tree, dict):
        return {k: encode_complex(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(encode_complex(v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)) and tree.dtype in (
            np.complex64, np.complex128, torch.complex64, torch.complex128):
        return {_COMPLEX_TAG + "re": tree.real, _COMPLEX_TAG + "im": tree.imag}
    return tree


def decode_complex(tree):
    """Inverse of ``encode_complex``: ``{re, im}`` pairs back to complex
    tensors."""
    if isinstance(tree, dict):
        if _COMPLEX_TAG + "re" in tree:
            re = torch.as_tensor(tree[_COMPLEX_TAG + "re"])
            return torch.complex(re, torch.as_tensor(tree[_COMPLEX_TAG + "im"], device=re.device))
        return {k: decode_complex(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(decode_complex(v) for v in tree)
    return tree


def params_to(params, device):
    """A solve's ``params`` with every array and tensor on ``device``,
    nested dicts, lists and tuples included (a denoiser's weight dict
    under its ``param_key``); ``.to`` keeps a tensor's autograd graph."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    if isinstance(params, (np.ndarray, torch.Tensor)):
        return to_tensor(params, device=device)
    return params


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

    def _has_stateful(self):
        """Whether a proxfn carries state between iterations
        (``unrolled_prior``): the loop hands it the step index as an int
        and resets it at the start of every solve."""
        return any(getattr(fn, "stateful", False) for fn in self.psi_fns + self.omega_fns)

    def _run(self, x0, rhos, lams, max_iter, params, on_step=None):
        for fn in self.psi_fns + self.omega_fns:
            if getattr(fn, "stateful", False):
                fn.reset()
        orig_shape = tuple(x0.shape) if hasattr(x0, "shape") else None
        x0 = self._prepare_x0(x0)
        rhos, lam_list = self.defaults(rhos, lams, max_iter)
        # placeholder values go to the solver's device once, not per iteration
        params = params_to(dict(params or {}), self.device)
        state = self.initialize(x0, params)
        aux = self.prepare_aux(x0, params)
        for it in range(max_iter):
            rho = rhos[it]
            lam = [l[it] for l in lam_list]
            p_it = dict(params, __step__=it)
            new = self._iter(state, rho, lam, it, p_it, aux)
            if on_step is not None and on_step(it, state, new, rho, lam, p_it):
                return new, orig_shape, it + 1
            state = new
        return state, orig_shape, max_iter

    # ------------------------------------------------------------------ #
    # Solve
    # ------------------------------------------------------------------ #

    def solve(self, x0=None, rhos=None, lams=None, max_iter: int = 24,
              params: Optional[Params] = None, callback: Optional[Callable] = None,
              real_output: bool = False, return_full_states: bool = False):
        """Run the solver; returns x* (its real part with ``real_output``,
        for a complex state). ``callback(iter=, state=, rho=, lam=)`` runs
        after every iteration. ``return_full_states``: the trajectory
        instead, the state after each iteration stacked along a new leading
        axis (x: [max_iter, B, ...]), as the JAX package's jitted solve
        returns it."""
        traj = []

        def on_step(it, prev, new, rho, lam, p_it):
            if callback is not None:
                callback(iter=it, state=new, rho=rho, lam=lam)
            if return_full_states:
                traj.append(new)

        state, orig_shape, _ = self._run(x0, rhos, lams, max_iter, params, on_step)
        if return_full_states:
            return tree_map(lambda *ts: torch.stack(ts), *traj)
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

        state, orig_shape, _ = self._run(x0, rhos, lams, max_iter, params, on_step)
        out = self._restore_shape(state[0], orig_shape)
        return (out.real if real_output else out,
                {k: torch.stack(v) if v else torch.zeros(0) for k, v in res.items()})

    def solve_until(self, x0=None, rhos=None, lams=None, max_iter: int = 100,
                    tol: float = 1e-4, params: Optional[Params] = None,
                    real_output: bool = True):
        """Solve until both relative residuals fall to ``tol`` or below (or
        ``max_iter``); returns ``(x, iterations)``. The stop test reads the
        two residuals to the host once an iteration. Needs an algorithm
        with residual tracking (the ADMM family)."""
        def on_step(it, prev, new, rho, lam, p_it):
            r = self.residuals(prev, new, rho, p_it)
            if r is None:
                raise NotImplementedError(
                    f"{type(self).__name__} does not track primal/dual residuals; "
                    "solve_until needs the ADMM family")
            return max(torch.stack([r["r_primal"], r["r_dual"]]).tolist()) <= tol

        state, orig_shape, k = self._run(x0, rhos, lams, max_iter, params, on_step)
        out = self._restore_shape(state[0], orig_shape)
        return (out.real if real_output else out), k

    def iters(self, state, rhos, lam_list, max_iter: int, params: Optional[Params] = None,
              offsets: Optional[IterAux] = None, x_ref=None):
        """Advance ``state`` by ``max_iter`` iterations (the RL tuner's
        inner loop). ``rhos`` / ``lam_list`` take every form ``defaults``
        takes, [B, max_iter] per sample included; ``offsets``: the
        ``prepare_aux`` of ``x_ref`` (default: of ``state[0]``), computed
        here when not given."""
        params = params_to(dict(params or {}), self.device)
        if offsets is None:
            offsets = self.prepare_aux(x_ref if x_ref is not None else state[0], params)
        rhos, lam_tuple = self.defaults(rhos, lam_list, max_iter)
        for it in range(max_iter):
            state = self._iter(state, rhos[it], [l[it] for l in lam_tuple], it,
                               dict(params, __step__=it), offsets)
        return state

    # ------------------------------------------------------------------ #
    # State helpers: the tuple state flattened along the channel axis
    # ------------------------------------------------------------------ #

    def pack(self, state) -> Array:
        flat = []
        for s in state:
            if isinstance(s, (list, tuple)):
                flat.extend(s)
            else:
                flat.append(s)
        return torch.cat(flat, dim=1)

    def unpack(self, tensor: Array):
        """Inverse of ``pack``: a list with one tensor for each single
        block of ``state_split`` and a list for each group."""
        parts = torch.tensor_split(tensor, self.state_dim, dim=1)
        out, idx = [], 0
        for d in self.state_split:
            if d == 1:
                out.append(parts[idx])
                idx += 1
            else:
                out.append(list(parts[idx:idx + d[0]]))
                idx += d[0]
        return out

    @property
    def state_dim(self) -> int:
        return sum(s if isinstance(s, int) else sum(s) for s in self.state_split)

    @property
    def state_split(self):
        """The state's blocks: 1 for a single tensor, [n] for a group of n."""
        raise NotImplementedError

    @property
    def nparams(self):
        raise NotImplementedError
