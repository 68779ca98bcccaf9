"""User primitives (counterpart of dprox_tpu/algo/primitives.py).

``compile`` partitions a proxfn objective and instantiates the chosen
solver on a device; ``specialize`` wraps it for unrolling, DEQ or RL
tuning; ``train`` runs the supervised loop (or the tuner's own);
``optimize`` runs the absorb pass; ``visualize`` renders the proxfns'
linop trees.
"""
from __future__ import annotations

from typing import List

from ..proxfn.base import ProxFn
from .absorb import absorb_all_linops
from .admm import ADMM, ADMM_vxu, LinearizedADMM
from .cadmm import ConsensusADMM
from .hqs import HQS
from .pc import PockChambolle
from .pgd import ProximalGradientDescent

SOLVERS = {
    "admm": ADMM,
    "admm_vxu": ADMM_vxu,
    "ladmm": LinearizedADMM,
    "hqs": HQS,
    "pc": PockChambolle,
    "pgd": ProximalGradientDescent,
    "cadmm": ConsensusADMM,
}


def compile(prox_fns: List[ProxFn], method: str = "admm", device="cuda", **kwargs):
    """Partition the objective and instantiate the chosen solver on
    ``device`` (moving the objective's data there)."""
    if isinstance(prox_fns, ProxFn):
        prox_fns = [prox_fns]
    if method not in SOLVERS:
        raise ValueError(f"unknown method '{method}'; available: {sorted(SOLVERS)}")
    algorithm = SOLVERS[method]
    psi_fns, omega_fns = algorithm.partition(prox_fns)
    return algorithm(psi_fns, omega_fns, device=device, **kwargs)


def optimize(prox_fns: List[ProxFn], merge=False, absorb=True):
    """Problem-rewrite passes: the absorb pass (merge is not a pass, as in
    the JAX package)."""
    if absorb:
        prox_fns = absorb_all_linops(prox_fns)
    return prox_fns


def specialize(solver, method: str = "deq", **kwargs):
    """Wrap a compiled solver for learning: "unroll", "deq" or "rl"."""
    from .special import SPECIALIZATIONS

    return SPECIALIZATIONS[method](solver, **kwargs)


def train(solver=None, step_fn=None, dataset=None, **kwargs):
    """An ``AutoTuneSolver`` trains itself; otherwise the supervised loop
    ``special.training.train_supervised``."""
    from .special.rl import AutoTuneSolver
    from .special.training import train_supervised

    if isinstance(solver, AutoTuneSolver):
        return solver.train(dataset, **kwargs)
    return train_supervised(step_fn=step_fn, dataset=dataset, **kwargs)


def visualize(prox_fns=None, filename=None):
    """The dot source of each proxfn's linop tree (``linop.visualize``),
    separated by blank lines; None without proxfns."""
    from ..linop.visualize import visualize as _visualize

    if prox_fns is None:
        return None
    if not isinstance(prox_fns, list):
        prox_fns = [prox_fns]
    return "\n\n".join(_visualize(fn.linop, filename) for fn in prox_fns)
