"""Problem-rewrite passes: absorb linops into proxfns.

Counterpart of dprox_tpu/algo/absorb.py: fold ``scale`` into fn.beta, and
a ``sum_squares(mosaic(x), b)`` data term into the closed-form
``weighted_sum_squares``.
"""
from __future__ import annotations

from ..linop.base import scale
from ..linop.ops import mosaic
from ..proxfn.sum_squares import sum_squares, weighted_sum_squares


def absorb_all_linops(prox_fns):
    new_proxes, ready = [], list(prox_fns)
    while ready:
        curr = ready.pop(0)
        absorbed = absorb_linop(curr)
        if len(absorbed) == 1 and absorbed[0] is curr:
            new_proxes.append(curr)
        else:
            ready.extend(absorbed)
    return new_proxes


def absorb_linop(prox_fn):
    if isinstance(prox_fn.linop, mosaic) and isinstance(prox_fn, sum_squares):
        if prox_fn._b is None:
            raise ValueError("mosaic absorb requires sum_squares(mosaic(x), b=...)")
        return [weighted_sum_squares(prox_fn.linop.children[0], prox_fn.linop, prox_fn._b)]
    if isinstance(prox_fn.linop, scale):
        scalar = prox_fn.linop.scalar
        prox_fn.linop = prox_fn.linop.children[0]
        prox_fn.beta = prox_fn.beta * scalar
        return [prox_fn]
    return [prox_fn]
