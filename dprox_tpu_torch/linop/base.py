"""Linear-operator expression DSL.

Counterpart of dprox_tpu/linop/base.py: operators form a static Python
expression tree; variable values flow through ``forward`` as a
``{name: tensor}`` dict, and adjoint contributions of fan-outs
accumulate into a per-variable dict. ``to(device)`` moves the tree's
constant data; operators that build data from shapes (conv's OTF) make
it on the tree's device.

Diagonality protocol (drives the least-squares dispatch):

* ``is_diag(freq)``      — is K (freq-)diagonal?
* ``is_gram_diag(freq)`` — is K^T K (freq-)diagonal?
* ``diag(shape, params, freq)``      — amplitude diagonal of K
* ``gram_diag(shape, params, freq)`` — diagonal of K^T K (= |diag|^2)
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.misc import to_tensor

Array = torch.Tensor
Params = Dict[str, Array]

_counter = itertools.count()


def cast_to_const(expr) -> "LinOp":
    """Wrap a raw array/scalar as a Constant."""
    return expr if isinstance(expr, LinOp) else Constant(expr)


class LinOp:
    """Abstract linear operator node."""

    def __init__(self, children: Sequence["LinOp"] = ()):
        self.children = tuple(cast_to_const(c) for c in children)
        self.linop_id = next(_counter)
        self.device = torch.device("cpu")

    def to(self, device) -> "LinOp":
        """Move the tree's data to ``device`` (in place); returns self."""
        self.device = torch.device(device)
        for c in self.children:
            c.to(device)
        return self

    # ------------------------------------------------------------------ #
    # Computation
    # ------------------------------------------------------------------ #

    def forward(self, inputs: Dict[str, Array], params: Optional[Params] = None,
                zero_constants: bool = False, cache: Optional[dict] = None) -> Array:
        """K applied to variable values ``inputs``; ``zero_constants``
        evaluates only the linear part, ``cache`` memoizes shared
        subexpressions."""
        if cache is None:
            cache = {}
        key = (id(self), zero_constants)
        if key not in cache:
            cache[key] = self._forward(
                [c.forward(inputs, params, zero_constants, cache) for c in self.children],
                params,
            )
        return cache[key]

    def adjoint(self, y: Array, params: Optional[Params] = None) -> Dict[str, Array]:
        """K^T y, returned as accumulated per-variable contributions."""
        acc: Dict[str, Array] = {}
        self.adjoint_into(y, params, acc)
        return acc

    def adjoint_into(self, y: Array, params: Optional[Params], acc: Dict[str, Array]):
        for child, yc in zip(self.children, self._adjoint(y, params)):
            child.adjoint_into(yc, params, acc)

    def _forward(self, child_values: Sequence[Array], params: Optional[Params]) -> Array:
        raise NotImplementedError

    def _adjoint(self, y: Array, params: Optional[Params]) -> Sequence[Array]:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # Structure
    # ------------------------------------------------------------------ #

    @property
    def variables(self):
        """Unique Variables in creation order."""
        seen, out = set(), []
        for c in self.children:
            for v in c.variables:
                if v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
        return sorted(out, key=lambda v: v.linop_id)

    @property
    def constants(self):
        out = []
        for c in self.children:
            out.extend(c.constants)
        return out

    def is_constant(self) -> bool:
        return len(self.variables) == 0

    def offset(self, var_shapes: Dict[str, tuple], params: Optional[Params] = None,
               dtype=torch.float32) -> Array:
        """Constant offset: the tree's value with all variables zeroed,
        evaluated structurally (purely linear subtrees are skipped)."""
        res = self._offset_rec(var_shapes, params, dtype)
        if res is None:
            return self.forward(self._zeros(var_shapes, dtype), params)
        return res

    def _zeros(self, var_shapes, dtype):
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, shape in var_shapes.items()}

    def _offset_rec(self, var_shapes, params, dtype):
        if not self.constants:
            return None  # linear in the variables: contributes zero
        if self.is_constant():
            return self.forward({}, params)
        if isinstance(self, sum):
            out = None
            for c in self.children:
                r = c._offset_rec(var_shapes, params, dtype)
                if r is not None:
                    out = r if out is None else out + r
            return out
        return self.forward(self._zeros(var_shapes, dtype), params)

    # ------------------------------------------------------------------ #
    # Diagonality
    # ------------------------------------------------------------------ #

    def is_diag(self, freq: bool = False) -> bool:
        return False

    def is_gram_diag(self, freq: bool = False) -> bool:
        return self.is_diag(freq)

    def diag(self, shape, params: Optional[Params] = None, freq: bool = False) -> Array:
        """Amplitude diagonal of K, broadcastable to ``shape`` (BCHW)."""
        raise NotImplementedError(f"{type(self).__name__} has no diagonal")

    def gram_diag(self, shape, params: Optional[Params] = None, freq: bool = False) -> Array:
        d = self.diag(shape, params, freq)
        return torch.abs(torch.conj(d) * d)

    # ------------------------------------------------------------------ #
    # Frequency-circulant gram surrogate (preconditioning)
    # ------------------------------------------------------------------ #

    def _own_gram_surrogate(self, shape, params: Optional[Params] = None):
        """Circulant approximation of THIS op's gram factor in the
        frequency domain (children excluded): exact for freq-diagonal ops,
        the per-channel spatial average for spatially-diagonal ops, None
        when there is no sensible surrogate (which disables
        preconditioning for the tree)."""
        return None

    def gram_freq_surrogate(self, shape, params: Optional[Params] = None):
        """Approximate frequency-domain diagonal of this subtree's gram
        K^T K, the Jacobi-in-frequency preconditioner of the CG x-update.
        A chain multiplies its factors' surrogates (exact when every
        factor is circulant, an average otherwise). None when any factor
        has no surrogate."""
        own = self._own_gram_surrogate(shape, params)
        if own is None:
            return None
        out = own
        for c in self.children:
            cs = c.gram_freq_surrogate(shape, params)
            if cs is None:
                return None
            out = out * cs
        return out

    # ------------------------------------------------------------------ #
    # Operator algebra
    # ------------------------------------------------------------------ #

    def __add__(self, other):
        other = cast_to_const(other)
        args = []
        for elem in (self, other):
            args.extend(elem.children if isinstance(elem, sum) else [elem])
        return sum(args)

    def __radd__(self, other):
        return cast_to_const(other) + self

    def __mul__(self, other):
        if np.isscalar(other):
            return scale(other, self)
        raise TypeError("Can only multiply a LinOp by a scalar constant.")

    __rmul__ = __mul__

    def __truediv__(self, other):
        if np.isscalar(other):
            return scale(1.0 / other, self)
        raise TypeError("Can only divide a LinOp by a scalar constant.")

    def __sub__(self, other):
        return self + (-cast_to_const(other))

    def __rsub__(self, other):
        return (-self) + cast_to_const(other)

    def __neg__(self):
        return scale(-1.0, self)

    def __rmatmul__(self, other):
        # A @ x: the objective/constraint records of the LP path
        from .constraints import matmul

        return matmul(self, other)

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(repr(c) for c in self.children)})"

    # a LinOp on the right of an ndarray operator wins the dispatch
    __array_priority__ = 10000


class Variable(LinOp):
    """Leaf variable; identity forward/adjoint."""

    def __init__(self, shape=None, name: Optional[str] = None):
        super().__init__([])
        self.shape = shape
        self.name = name if name is not None else f"var{self.linop_id}"

    def forward(self, inputs, params=None, zero_constants=False, cache=None):
        return inputs[self.name]

    def adjoint_into(self, y, params, acc):
        if self.name in acc:
            acc[self.name] = acc[self.name] + y
        else:
            acc[self.name] = y

    @property
    def variables(self):
        return [self]

    def is_diag(self, freq: bool = False) -> bool:
        return True

    def diag(self, shape, params=None, freq: bool = False):
        return torch.ones((), dtype=torch.float32, device=self.device)

    def _own_gram_surrogate(self, shape, params=None):
        return 1.0

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape})"


class Constant(LinOp):
    """Constant leaf; zero linear part."""

    def __init__(self, value):
        super().__init__([])
        self.value = to_tensor(value, batch=True)

    def to(self, device):
        super().to(device)
        self.value = self.value.to(device)
        return self

    def forward(self, inputs, params=None, zero_constants=False, cache=None):
        if zero_constants:
            return torch.zeros_like(self.value)
        return self.value

    def adjoint_into(self, y, params, acc):
        pass  # adjoint of a constant is zero: contributes nothing

    @property
    def constants(self):
        return [self]

    def is_diag(self, freq: bool = False) -> bool:
        return True

    def diag(self, shape, params=None, freq: bool = False):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def __repr__(self):
        return f"Constant(shape={tuple(self.value.shape)})"


class Placeholder(LinOp):
    """Named runtime constant; its value is the entry of ``params`` under
    its name at call time, so it can change per solve (an observation, a
    learned PSF) and receive gradients."""

    def __init__(self, name: Optional[str] = None, batch: bool = True):
        super().__init__([])
        self.name = name if name is not None else f"ph{self.linop_id}"
        self.batch = batch

    def value(self, params: Optional[Params]):
        if params is None or self.name not in params:
            raise KeyError(
                f"Placeholder '{self.name}' has no value; pass params={{'{self.name}': ...}}")
        return to_tensor(params[self.name], batch=self.batch, device=self.device)

    def forward(self, inputs, params=None, zero_constants=False, cache=None):
        v = self.value(params)
        if zero_constants:
            return torch.zeros_like(v)
        return v

    def adjoint_into(self, y, params, acc):
        pass

    @property
    def constants(self):
        return [self]

    def is_diag(self, freq: bool = False) -> bool:
        return True

    def diag(self, shape, params=None, freq: bool = False):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def __repr__(self):
        return f"Placeholder(name={self.name})"


class scale(LinOp):
    """Multiplication by a fixed scalar."""

    def __init__(self, scalar, arg):
        if not np.isscalar(scalar):
            raise TypeError(f"scale needs a scalar, got {type(scalar).__name__}")
        self.scalar = float(scalar)
        super().__init__([arg])

    def _forward(self, child_values, params):
        return child_values[0] * self.scalar

    def _adjoint(self, y, params):
        return [y * self.scalar]

    def is_diag(self, freq: bool = False) -> bool:
        return self.children[0].is_diag(freq)

    def is_gram_diag(self, freq: bool = False) -> bool:
        return self.children[0].is_gram_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        return self.children[0].diag(shape, params, freq) * self.scalar

    def gram_diag(self, shape, params=None, freq: bool = False):
        return self.children[0].gram_diag(shape, params, freq) * (self.scalar**2)

    def _own_gram_surrogate(self, shape, params=None):
        return self.scalar ** 2


class sum(LinOp):
    """Sum of N inputs; adjoint broadcasts."""

    def _forward(self, child_values, params):
        out = child_values[0]
        for v in child_values[1:]:
            out = out + v
        return out

    def _adjoint(self, y, params):
        return [y] * len(self.children)

    def is_diag(self, freq: bool = False) -> bool:
        return all(c.is_diag(freq) for c in self.children)

    def is_gram_diag(self, freq: bool = False) -> bool:
        return all(c.is_gram_diag(freq) for c in self.children)

    def diag(self, shape, params=None, freq: bool = False):
        out = None
        for c in self.children:
            d = c.diag(shape, params, freq)
            out = d if out is None else out + d
        return out

    def gram_freq_surrogate(self, shape, params=None):
        # constants (offsets like ``conv(x) - b``) add nothing to the
        # variable gram; cross terms of more than one variable branch have
        # no circulant surrogate
        live = [c for c in self.children if not c.is_constant()]
        if len(live) != 1:
            return None
        return live[0].gram_freq_surrogate(shape, params)


class vstack(LinOp):
    """Stack of independent operator branches (list in, list out); the
    solvers work on per-ProxFn operator lists, so this node serves the
    joint diagonality queries."""

    def forward_list(self, inputs, params=None, zero_constants=False):
        cache: dict = {}
        return [c.forward(inputs, params, zero_constants, cache) for c in self.children]

    def adjoint_list(self, ys, params=None) -> Dict[str, Array]:
        acc: Dict[str, Array] = {}
        for c, y in zip(self.children, ys):
            c.adjoint_into(y, params, acc)
        return acc

    def is_gram_diag(self, freq: bool = False) -> bool:
        return all(c.is_gram_diag(freq) for c in self.children)

    def gram_diag(self, shape, params=None, freq: bool = False):
        out = None
        for c in self.children:
            d = c.gram_diag(shape, params, freq)
            out = d if out is None else out + d
        return out

    def gram_freq_surrogate(self, shape, params=None):
        # the gram of a stack is the sum of the per-branch grams
        out = None
        for c in self.children:
            s = c.gram_freq_surrogate(shape, params)
            if s is None:
                return None
            out = s if out is None else out + s
        return out


class split(vstack):
    """Transpose of ``vstack``: forward and adjoint are vstack's swapped.
    It exists for API parity; the solvers consume fn lists directly."""

    def forward_list(self, ys, params=None, zero_constants=False):
        return super().adjoint_list(ys, params)

    def adjoint_list(self, inputs, params=None):
        return super().forward_list(inputs, params)
