"""Quadratic proxfns and the least-squares x-update engine.

Counterpart of dprox_tpu/proxfn/sum_squares.py (``sum_squares`` with
``grad``, ``weighted_sum_squares``, ``least_squares`` with ``prepare`` /
``solve_direct`` / ``solve_cg`` / ``_freq_xupdate``). The
``least_squares`` solve is the hot path of every proximal algorithm:

* (freq-)diagonalizable stacked operator -> closed-form division, the
  frequency case as batched 2-D FFTs around the ``freq_divide`` kernel
  (ops/kernels.py);
* otherwise -> matrix-free CG through ``linalg.linear_solve`` with
  implicit gradients, preconditioned in the frequency domain when the
  operator tree has a circulant surrogate.

With a ``spatial_mesh`` the frequency x-update runs with the image
sharded in H over a mesh axis: the distributed FFT pair
(``parallel/fft.py``) around the same ``freq_divide`` kernel, applied to
each rank's W slab of the spectrum.

``ext_sum_squares`` is the base of the fused fast proxes
(``proxfn/fast``), whose closed-form ``_solve`` is the whole x-update.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..linalg import LinearSolveConfig, linear_solve
from ..linalg.structured import mosaic_conv_pcg
from ..linop.base import LinOp, Params, Placeholder, Variable, vstack
from ..linop.base import sum as linop_sum
from ..linop.ops import conv, mosaic
from ..ops.kernels import freq_divide
from ..utils.misc import expand_to_bchw, to_tensor
from ..utils.profiling import span
from .base import Array, HeldData, ProxFn


def _fftn2(x):
    return torch.fft.fftn(x, dim=(-2, -1))


def _ifftn2(x):
    return torch.fft.ifftn(x, dim=(-2, -1))


# Size gates of the frequency x-update, kept from the JAX package, where
# they were measured on a TPU (not yet re-measured on a GPU): at and above
# 2048^2 per plane the x-update uses the half-spectrum rfft pair (exact:
# the numerator is conjugate-symmetric and the divisor even-symmetric) and
# runs one (batch, channel) plane at a time.
_RFFT_MIN_PLANE = 2048 * 2048
_MAP_MIN_PLANE = 2048 * 2048


def _freq_xupdate(spatial, freq_const, diag, rho, eps):
    """``real(ifft2((freq_const + fft2(spatial) + eps) / (diag + rho + eps)))``
    over [B, C, H, W], with the divide in the ``freq_divide`` kernel.

    ``spatial`` or ``freq_const`` (complex full-spectrum numerator, e.g.
    the hoisted conj(H)*F(b)) may each be None; ``diag`` is the gram
    diagonal (full-spectrum tensor, broadcastable); ``rho`` a tensor
    holding one value or one per batch element. The half-spectrum branch
    is exact only for a real ``spatial`` and a real, even-symmetric
    divisor; a complex ``diag`` or a complex ``spatial`` takes the
    full-complex pair at every size, a complex divisor's divide in the
    kernel's complex-divisor entry.
    """
    ref = spatial if spatial is not None else freq_const
    Hs, Ws = int(ref.shape[-2]), int(ref.shape[-1])
    plane = Hs * Ws
    sym_ok = not (diag.is_complex() or (spatial is not None and spatial.is_complex()))
    if plane < _RFFT_MIN_PLANE or not sym_ok:
        F = _fftn2(spatial) if spatial is not None else None
        F = freq_const if F is None else (F if freq_const is None else freq_const + F)
        return _ifftn2(freq_divide(F, diag, rho, eps)).real

    half = Ws // 2 + 1
    fc = freq_const[..., :half] if freq_const is not None else None
    dg = diag[..., :half] if diag.ndim >= 1 and diag.shape[-1] == Ws else diag

    def tail(sp, fc_i, dg_i, rho_i):
        F = torch.fft.rfftn(sp, dim=(-2, -1)) if sp is not None else None
        F = fc_i if F is None else (F if fc_i is None else fc_i + F)
        return torch.fft.irfftn(freq_divide(F.contiguous(), dg_i, rho_i, eps),
                                s=(Hs, Ws), dim=(-2, -1))

    B, C = ref.shape[0], ref.shape[1]
    if plane < _MAP_MIN_PLANE or B * C <= 1:
        return tail(spatial, fc, dg, rho)
    # one (batch, channel) plane at a time; views, no copies
    dg_b = torch.broadcast_to(dg, (B, C) + tuple(dg.shape[-2:])) if dg.ndim else dg
    rho_f = rho.reshape(-1)
    out = torch.empty(ref.shape, dtype=torch.float32, device=ref.device)
    for b in range(B):
        rho_b = rho_f[b:b + 1] if rho_f.numel() > 1 else rho_f
        for c in range(C):
            out[b, c] = tail(spatial[b:b + 1, c:c + 1] if spatial is not None else None,
                             fc[b:b + 1, c:c + 1] if fc is not None else None,
                             dg_b[b, c] if dg.ndim else dg, rho_b)[0, 0]
    return out


def _divisor(diag_quad, diag_psi, rho, with_v: bool):
    """Split the x-update divisor ``diag_quad + rho*diag_psi (+ rho)`` into
    the kernel's ``(diag, rho)`` operands, in the JAX package's summation
    order. With a scalar psi diagonal (a Variable) and no v term the
    divisor is ``diag_quad + (rho*diag_psi)``: the kernel adds the per-batch
    scalar itself and no divisor plane is materialized per iteration."""
    def operand(d):  # float32, or complex64 for a complex spectrum
        d = torch.as_tensor(d, device=rho.device)
        return d.to(torch.complex64 if d.is_complex() else torch.float32)

    psi = torch.as_tensor(diag_psi)
    if not with_v and psi.ndim == 0 and not psi.is_complex():
        return operand(diag_quad), rho * diag_psi
    return operand(diag_quad + rho * diag_psi), (rho if with_v else torch.zeros_like(rho))


def _freq_jacobi_minv(theta, r):
    """Preconditioner of the CG x-update: theta[2] is the
    frequency-circulant surrogate diagonal of K^T K + rho terms
    (least_squares.prepare); M^{-1} r = F^{-1}(F r / Mdiag)."""
    out = _ifftn2(_fftn2(r) / theta[2])
    return out if r.is_complex() else out.real.to(r.dtype)


def _linear_part(op: LinOp) -> Optional[LinOp]:
    """``op`` without the constant branches of its ``sum`` nodes (an offset
    such as ``- b``: zero in the x-update's matvec), or None where a sum
    has more than one branch with a variable."""
    while isinstance(op, linop_sum):
        live = [c for c in op.children if not c.is_constant()]
        if len(live) != 1:
            return None
        op = live[0]
    return op


def _mosaic_conv(quad_fns, other_fns) -> Optional[conv]:
    """The ``conv`` node where the x-update's system is K^T K + n rho I with
    K = ``mosaic(conv(x))`` of a static kernel: one quadratic term of that
    operator and every other term's operator the variable itself. None
    otherwise."""
    if len(quad_fns) != 1:
        return None
    op = _linear_part(quad_fns[0].linop)
    if not (isinstance(op, mosaic) and isinstance(op.children[0], conv)):
        return None
    kernel_op, var = op.children[0], op.children[0].children[0]
    if not isinstance(var, Variable):
        return None
    if not all(isinstance(fn.linop, Variable) and fn.linop.name == var.name
               for fn in other_fns):
        return None
    return kernel_op


def _is_field(t, shape=None) -> bool:
    """A contiguous float32 [B, 3, H, W] tensor (of ``shape`` where given)."""
    return (isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.ndim == 4
            and t.shape[1] == 3 and t.is_contiguous()
            and (shape is None or t.shape == shape))


class sum_squares(ProxFn):
    """||K x - b||^2; ``b`` may be an array or a ``Placeholder``."""

    def __init__(self, linop: LinOp, b=None, eps: float = 1e-7):
        super().__init__(linop)
        self.eps = eps
        self._b = b if b is None or isinstance(b, Placeholder) else to_tensor(b, batch=True)

    def to(self, device):
        super().to(device)
        if self._b is not None:
            self._b = self._b.to(device)  # a tensor, or a Placeholder's device
        return self

    def offset(self, var_shapes, params=None):
        if self._b is not None:
            return self.unwrap_b(params)
        return super().offset(var_shapes, params)

    def unwrap_b(self, params: Optional[Params]):
        if isinstance(self._b, Placeholder):
            return self._b.value(params)
        return self._b

    def _prox(self, v, lam, params=None, step=None):
        return v / (1.0 + 2.0 * lam)

    def grad(self, x: Array, params: Optional[Params] = None) -> Array:
        """K^T (K x - b): the gradient role in PGD."""
        var = self.linop.variables[0]
        off = self.offset({var.name: tuple(x.shape)}, params)
        tmp = self.dag_forward(x, params)
        if off is not None:
            tmp = tmp - off
        return self.dag_adjoint(tmp, params)


class ext_sum_squares(HeldData, sum_squares):
    """Base of the fused fast data-term proxes (csmri, sisr, misr,
    compress_sensing, spi): a subclass's ``_solve(xtilde, rho, n, params)``
    is the whole x-update in closed form, given the sum ``xtilde`` of the
    n consensus blocks. ``complex_state`` says that the solve lives in
    k-space and the solver's state must be complex."""

    complex_state = False

    def __init__(self, linop: LinOp, eps: float = 1e-7):
        super().__init__(linop, eps=eps)
        self._setup_bs = []

    def setup(self, bs: Sequence[Array]):
        self._setup_bs = list(bs)
        return self

    def solve(self, vs: Sequence[Array], rho, params: Optional[Params] = None,
              var_shapes=None, prepared=None, warm=None) -> Array:
        """The fused x-update of ``sum(vs)``; ``var_shapes``, ``prepared``
        and ``warm`` are taken for the solvers' interface and unused (the
        solve is closed-form). Traced as the span ``dprox.xupdate``."""
        with span("dprox.xupdate"):
            xtilde = 0.0
            for v in vs:
                xtilde = xtilde + v
            rho = torch.as_tensor(rho, dtype=torch.float32, device=vs[0].device)
            return self._solve(xtilde, expand_to_bchw(rho), len(vs), params)

    def _solve(self, xtilde, rho, n, params):
        raise NotImplementedError


class weighted_sum_squares(sum_squares):
    """||A x - b||^2 with a (freq-)diagonal ``weight`` A and a closed-form
    prox; the absorb pass makes one of ``sum_squares(mosaic(x), b)``.

    The frequency prox builds its numerator as conj(H) F(b) + lam F(v) (no
    ifft -> fft round trip of b, as in ``least_squares.prepare``) and
    divides in the ``freq_divide`` kernel. Its ``prox`` replaces the
    modifiers of ``ProxFn.prox``, as in the JAX package.
    """

    def __init__(self, linop: LinOp, weight: LinOp, b, eps: float = 0.0):
        super().__init__(linop, b, eps)
        self.weight = weight
        if weight.is_diag(freq=False):
            self.freq = False
        elif weight.is_diag(freq=True):
            self.freq = True
        else:
            raise ValueError("weight must be (freq-)diagonalizable")

    def to(self, device):
        super().to(device)
        self.weight.to(device)
        return self

    def Ktb(self, params: Optional[Params]):
        from ..linop.evaluate import adjoint as linop_adjoint

        return linop_adjoint(self.weight, self.unwrap_b(params), params)

    def prox(self, v, lam, params=None, step=None, offset=None):
        with span("dprox.prox"):
            lam = expand_to_bchw(torch.as_tensor(lam, dtype=v.dtype, device=v.device))
            if not self.freq:
                diag = self.weight.gram_diag(v.shape, params, freq=False)
                return (self.Ktb(params) + lam * v) / (diag + lam)
            diag = self.weight.gram_diag(v.shape, params, freq=True)
            H = self.weight.diag(v.shape, params, freq=True)
            num = torch.conj(H) * _fftn2(self.unwrap_b(params)) + lam * _fftn2(v)
            return _ifftn2(freq_divide(num.to(torch.complex64), diag.to(torch.float32),
                                       lam.to(torch.float32), self.eps)).real.to(v.dtype)


class least_squares(ProxFn):
    """Stacked-quadratic x-update with direct (spatial or frequency
    diagonal) vs CG dispatch.

    quad_fns: the omega (data) terms whose offsets supply K^T b;
    other_fns: the psi terms contributing rho-weighted consensus blocks.

    ``spatial_mesh``: run the frequency x-update with the image sharded in
    H over the mesh axis ``spatial_axis`` (and the batch over
    ``spatial_batch_axis``): its output is a DTensor sharded so. H and W
    must divide the axis size, and the stacked operator must be
    frequency-diagonal.
    """

    def __init__(self, quad_fns: List[ProxFn], other_fns: List[ProxFn],
                 try_diagonalize: bool = True, try_freq_diagonalize: bool = True,
                 linear_solve_config: Optional[LinearSolveConfig] = None,
                 spatial_mesh=None, spatial_axis: str = "space",
                 spatial_batch_axis: Optional[str] = None):
        self.quad_fns = list(quad_fns)
        self.other_fns = list(other_fns)
        self.linear_solve_config = linear_solve_config or LinearSolveConfig()
        stacked = vstack([fn.linop for fn in self.quad_fns + self.other_fns])
        self.diagonalizable = stacked.is_gram_diag(freq=False) and try_diagonalize
        self.freq_diagonalizable = (stacked.is_gram_diag(freq=True) and try_diagonalize
                                    and try_freq_diagonalize)
        super().__init__(stacked)
        self._otf_held = None  # (conv's OTF, its contiguous copy) for the structured CG
        self.spatial_mesh = spatial_mesh
        if spatial_mesh is not None:
            if not self.freq_diagonalizable:
                raise ValueError("spatial_mesh shards the frequency x-update; this "
                                 "objective's x-update is not frequency-diagonal")
            from ..parallel.fft import make_distributed_fft2

            self._fft2, self._ifft2 = make_distributed_fft2(
                spatial_mesh, spatial_axis, batch_axis=spatial_batch_axis)
            lead = {spatial_batch_axis: 0} if spatial_batch_axis else {}
            self._row_dims = {**lead, spatial_axis: 2}  # space: H sharded
            self._col_dims = {**lead, spatial_axis: 3}  # spectrum: W sharded

    def _prox(self, v, lam, params=None, step=None):
        return self.solve([], lam, v=v, params=params)

    def prepare(self, var_shapes, params=None, ref_shape=None):
        """Hoist iteration-invariant work out of the solver loop: K^T b of
        the quadratic terms, the gram diagonals of a direct solve, or the
        preconditioner surrogates of a CG solve.

        On the frequency path K^T b is hoisted IN THE FREQUENCY DOMAIN as
        conj(H)*F(b), never ifft->fft roundtripped: the roundtrip's
        rounding error would later be divided by (|H|^2 + rho), which
        amplifies it ~1/rho where the OTF vanishes (DPIR schedules start
        at rho ~ 1e-6); multiplying by conj(H) suppresses it exactly there.
        """
        if self.spatial_mesh is not None:
            return self._prepare_sharded(var_shapes, params, ref_shape)
        prepared = {}
        freq_hoistable = (self.freq_diagonalizable
                          and all(fn.linop.is_diag(freq=True) for fn in self.quad_fns))
        if freq_hoistable:
            freq_Ktb = None
            for fn in self.quad_fns:
                off = fn.offset(var_shapes, params)
                if off is not None:
                    H = fn.linop.diag(tuple(off.shape), params, freq=True)
                    term = torch.conj(H) * _fftn2(off)
                    freq_Ktb = term if freq_Ktb is None else freq_Ktb + term
            prepared["freq_Ktb_quad"] = freq_Ktb
        else:
            Ktb_quad = 0.0
            for fn in self.quad_fns:
                off = fn.offset(var_shapes, params)
                if off is not None:
                    Ktb_quad = Ktb_quad + fn.dag_adjoint(off, params)
            prepared["Ktb_quad"] = Ktb_quad
        if ref_shape is not None:
            shape = ref_shape
        else:
            shape = next(iter(var_shapes.values())) if var_shapes else ()
        if self.diagonalizable or self.freq_diagonalizable:
            freq = self.freq_diagonalizable
            diag_quad = 0.0
            for fn in self.quad_fns:
                diag_quad = diag_quad + fn.linop.gram_diag(shape, params, freq)
            diag_psi = 0.0
            for fn in self.other_fns:
                diag_psi = diag_psi + fn.linop.gram_diag(shape, params, freq)
            prepared["diag_quad"] = diag_quad
            prepared["diag_psi"] = diag_psi
        elif shape:
            # CG path: a frequency-circulant Jacobi preconditioner
            # M = sum_quad surr(K^T K) + rho (sum_psi surr + 1); exact for
            # circulant factors, spatially averaged for masks
            pq, pp = 0.0, 0.0
            for fn in self.quad_fns:
                s = fn.linop.gram_freq_surrogate(shape, params)
                if s is None:
                    return prepared
                pq = pq + s
            for fn in self.other_fns:
                s = fn.linop.gram_freq_surrogate(shape, params)
                if s is None:
                    return prepared
                pp = pp + s
            prepared["precond_quad"] = pq
            prepared["precond_psi"] = pp
        return prepared

    # -- the x-update sharded over a spatial mesh ----------------------- #

    def _rows(self, x):
        """This rank's H rows of an image (DTensor or global value)."""
        from ..parallel.mesh import local_shard

        return local_shard(x, self.spatial_mesh, self._row_dims)

    def _cols(self, d):
        """This rank's W slab of a spectrum-shaped operand (a gram diagonal
        or OTF, broadcastable to [B, C, H, W]; a scalar as it is)."""
        from ..parallel.mesh import local_operand

        return local_operand(d, self.spatial_mesh, self._col_dims, ndim=4)

    def _prepare_sharded(self, var_shapes, params, ref_shape):
        """``prepare`` on this rank's blocks: the frequency hoist conj(H) F(b)
        and the gram diagonals as its W slab of the spectrum, a spatial
        K^T b as its H rows."""
        from ..parallel.mesh import to_global

        prepared = {}
        if all(fn.linop.is_diag(freq=True) for fn in self.quad_fns):
            freq_Ktb = None
            for fn in self.quad_fns:
                off = fn.offset(var_shapes, params)
                if off is not None:
                    H = fn.linop.diag(tuple(off.shape), params, freq=True)
                    term = torch.conj(self._cols(H)) * self._fft2.local(self._rows(off))
                    freq_Ktb = term if freq_Ktb is None else freq_Ktb + term
            prepared["freq_Ktb_quad"] = freq_Ktb
        else:
            Ktb_quad = 0.0
            for fn in self.quad_fns:
                off = fn.offset(var_shapes, params)
                if off is not None:
                    Ktb_quad = Ktb_quad + fn.dag_adjoint(to_global(off), params)
            prepared["Ktb_quad"] = self._rows(Ktb_quad) if torch.is_tensor(Ktb_quad) else Ktb_quad
        shape = ref_shape if ref_shape is not None else next(iter(var_shapes.values()))
        for key, fns in (("diag_quad", self.quad_fns), ("diag_psi", self.other_fns)):
            d = 0.0
            for fn in fns:
                d = d + fn.linop.gram_diag(shape, params, True)
            prepared[key] = self._cols(d)
        return prepared

    def _adjoint_rows(self, fn, y, params):
        """K^T y on this rank's rows: a Variable's adjoint is the identity,
        so it runs on the rows; any other operator runs on the whole
        image."""
        if isinstance(fn.linop, Variable):
            return fn.dag_adjoint(self._rows(y), params)
        from ..parallel.mesh import to_global

        return self._rows(fn.dag_adjoint(to_global(y), params))

    def _solve_sharded(self, b, rho, v, params, eps, prepared):
        """The frequency x-update on this rank's blocks: ``real(ifft2((F +
        eps) / (diag_quad + rho*diag_psi [+ rho] + eps)))`` with ``F`` the
        hoisted conj(H)F(b) plus the distributed FFT of this rank's rows of
        ``rho * sum_i K_i^T b_i [+ rho v]``, the divide the ``freq_divide``
        kernel on the W slab; returns a DTensor sharded in H."""
        from ..parallel.mesh import from_local

        hoisted = "freq_Ktb_quad" in prepared
        acc = None if hoisted else prepared["Ktb_quad"]
        for i, fn in enumerate(self.other_fns):
            term = rho * self._adjoint_rows(fn, b[i], params)
            acc = term if acc is None else acc + term
        if v is not None:
            term = rho * self._rows(v)
            acc = term if acc is None else acc + term
        F = prepared["freq_Ktb_quad"] if hoisted else None
        if acc is not None:
            F = self._fft2.local(acc) if F is None else F + self._fft2.local(acc)
        diag, r = _divisor(prepared["diag_quad"], prepared["diag_psi"], rho, v is not None)
        out = self._ifft2.local(freq_divide(F, diag, r, eps)).real.float().contiguous()
        return from_local(out, self.spatial_mesh, self._row_dims)

    def _var_shapes(self, ref: Array, var_shapes=None):
        if var_shapes is not None:
            return var_shapes
        names = set()
        for fn in self.quad_fns + self.other_fns:
            for v in fn.linop.variables:
                names.add(v.name)
        return {n: tuple(ref.shape) for n in names}

    def _prepared(self, b, v, params, var_shapes, prepared):
        if prepared is not None:
            return prepared
        ref = v if v is not None else b[0]
        return self.prepare(self._var_shapes(ref, var_shapes), params,
                            ref_shape=tuple(ref.shape))

    def _spatial_ktb(self, prepared, b, rho, v, params):
        """K^T b accumulation: hoisted quadratic part + rho-weighted psi
        adjoints (+ rho v), in the JAX package's summation order."""
        Ktb = prepared["Ktb_quad"]
        for i, fn in enumerate(self.other_fns):
            Ktb = Ktb + rho * fn.dag_adjoint(b[i], params)
        if v is not None:
            Ktb = Ktb + rho * v
        return Ktb

    def solve(self, b: Sequence[Array], rho, v: Optional[Array] = None,
              params: Optional[Params] = None, eps: float = 1e-7,
              var_shapes=None, prepared=None, warm=None) -> Array:
        """``warm``: previous iterate to warm-start the CG path (the direct
        path ignores it; no gradient flows through the warm start). Without
        psi terms (``b == []``) and ``v`` the x-update is the quadratic
        terms' own minimizer, and ``warm`` fixes the device. Traced as the
        span ``dprox.xupdate`` (utils/profiling.py), either route."""
        ref = v if v is not None else (b[0] if b else warm)
        if ref is None:
            raise ValueError("need b, v or warm for shape inference")
        with span("dprox.xupdate"):
            rho = expand_to_bchw(torch.as_tensor(rho, dtype=torch.float32, device=ref.device))
            if self.diagonalizable or self.freq_diagonalizable:
                return self.solve_direct(b, rho, v, params, eps, var_shapes, prepared)
            return self.solve_cg(b, rho, v, params, var_shapes, prepared, warm)

    def solve_direct(self, b, rho, v=None, params=None, eps: float = 1e-7,
                     var_shapes=None, prepared=None) -> Array:
        """Frequency-diagonal: ``real(ifft2((conj(H)F(b) + F(rho * sum_i
        K_i^T b_i [+ rho v]) + eps) / (diag_quad + rho*diag_psi [+ rho] +
        eps)))``; spatially diagonal: ``K^T b / (diag + eps)``. Without
        ``prepared`` the hoisted terms are computed here."""
        prepared = self._prepared(b, v, params, var_shapes, prepared)
        if self.spatial_mesh is not None:
            return self._solve_sharded(b, rho, v, params, eps, prepared)
        if "freq_Ktb_quad" in prepared:
            s = None
            for i, fn in enumerate(self.other_fns):
                term = rho * fn.dag_adjoint(b[i], params)
                s = term if s is None else s + term
            if v is not None:
                s = rho * v if s is None else s + rho * v
            diag, r = _divisor(prepared["diag_quad"], prepared["diag_psi"], rho, v is not None)
            return _freq_xupdate(s, prepared["freq_Ktb_quad"], diag, r, eps).float()
        Ktb = self._spatial_ktb(prepared, b, rho, v, params)
        if self.freq_diagonalizable:
            diag, r = _divisor(prepared["diag_quad"], prepared["diag_psi"], rho, v is not None)
            return _freq_xupdate(Ktb, None, diag, r, eps).float()
        diag = prepared["diag_quad"] + rho * prepared["diag_psi"]
        if v is not None:
            diag = diag + rho
        return (Ktb / (diag + eps)).float()

    def solve_cg(self, b, rho, v=None, params=None, var_shapes=None,
                 prepared=None, warm=None) -> Array:
        """Matrix-free (preconditioned) CG on ``sum_quad K^T K + rho sum_psi
        K^T K [+ rho]``, differentiable through ``linear_solve``."""
        prepared = self._prepared(b, v, params, var_shapes, prepared)
        Ktb = self._spatial_ktb(prepared, b, rho, v, params)
        with_v = v is not None
        quad_fns, other_fns = self.quad_fns, self.other_fns

        def KtK(theta, x):
            rho_, params_ = theta[0], theta[1]
            out = 0.0
            for fn in quad_fns:
                out = out + fn.dag_adjoint(fn.dag_forward(x, params_), params_)
            for fn in other_fns:
                out = out + rho_ * fn.dag_adjoint(fn.dag_forward(x, params_), params_)
            if with_v:
                out = out + rho_ * x
            return out

        cfg = self.linear_solve_config
        theta, Minv_fn = (rho, params or {}), None
        if ("precond_quad" in prepared and cfg.solver_type in ("cg", "pcg")
                and "Minv" not in cfg.solver_kwargs):
            # frequency-circulant Jacobi preconditioner (see prepare())
            Mdiag = prepared["precond_quad"] + rho * prepared["precond_psi"]
            if with_v:
                Mdiag = Mdiag + rho
            # dtype-aware rtol floor: past ~30 eps the preconditioned
            # iteration amplifies round-off through M^{-1} (up to 1/rho)
            # instead of converging
            floor = 30 * torch.finfo(Ktb.dtype).eps
            cfg = dataclasses.replace(cfg, solver_type="pcg", rtol=max(cfg.rtol, floor))
            theta, Minv_fn = (rho, params or {}, Mdiag), _freq_jacobi_minv
            structured = self._structured_pcg(cfg, Ktb, rho, Mdiag, warm, with_v)
        else:
            structured = None
        return linear_solve(KtK, Ktb, theta=theta, config=cfg, x0=warm, Minv_fn=Minv_fn,
                            structured=structured)

    def _structured_pcg(self, cfg, Ktb, rho, Mdiag, warm, with_v):
        """The solve of ``linalg.structured.mosaic_conv_pcg`` where this
        preconditioned x-update's system has its structure (``_mosaic_conv``)
        and its tensors are float32 fields, under the implicit gradient;
        else None and ``pcg`` runs as it is."""
        kernel_op = _mosaic_conv(self.quad_fns, self.other_fns)
        if (kernel_op is None or not cfg.use_analytic_grad
                or not set(cfg.solver_kwargs) <= {"verbose"} or not _is_field(Ktb)
                or (warm is not None and not _is_field(warm, Ktb.shape))
                or rho.dtype != torch.float32 or rho.numel() not in (1, Ktb.shape[0])
                or not isinstance(Mdiag, torch.Tensor) or Mdiag.dtype != torch.float32):
            return None
        otf = kernel_op._otf(Ktb.shape)
        if self._otf_held is None or self._otf_held[0] is not otf:
            self._otf_held = (otf, otf.contiguous())
        otf = self._otf_held[1]
        n_rho = len(self.other_fns) + (1 if with_v else 0)

        def solve(theta, b, x0=None, rtol=1e-6, max_iters=100):
            # theta = (rho, params, Mdiag): Mdiag as [1 or B, C, H, W]
            rows = theta[2].shape[0] if theta[2].ndim == 4 else 1
            mdiag = torch.broadcast_to(theta[2], (rows if rows in (1, b.shape[0]) else
                                                  b.shape[0],) + tuple(b.shape[1:]))
            return mosaic_conv_pcg(otf, n_rho, theta[0], mdiag.contiguous(), b, x0, rtol,
                                   max_iters)

        return solve

    def __repr__(self):
        return (f"least_squares(diagonalizable={self.diagonalizable}, "
                f"freq_diagonalizable={self.freq_diagonalizable})")
