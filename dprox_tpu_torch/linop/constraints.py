"""LP objective/constraint records: c @ x, A @ x <= b, A @ x == b.

Counterpart of dprox_tpu/linop/constraints.py; ``Problem`` dispatches
these onto the LP solver path.
"""
from __future__ import annotations


class matmul:
    def __init__(self, x, A):
        self.x = x
        self.A = A

    def __le__(self, b):
        return less(self, b)

    def __ge__(self, b):
        raise NotImplementedError("use the A @ x <= b form")

    def __eq__(self, b):  # noqa: A003 - the operator builds a constraint
        return equality(self, b)

    def __hash__(self):
        return id(self)


class equality:
    def __init__(self, mm: matmul, b):
        self.x = mm.x
        self.A = mm.A
        self.b = b


class less:
    def __init__(self, mm: matmul, b):
        self.x = mm.x
        self.A = mm.A
        self.b = b
