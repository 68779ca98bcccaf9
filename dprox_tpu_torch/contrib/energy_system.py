"""Energy-system planning LP loader.

Counterpart of dprox_tpu/contrib/energy_system.py (numpy/scipy only):
loads the simple_cep_model .mat instance when the file is given or lies
under the repository's ``weights/`` directory, and splits its constraints
by sense; otherwise falls back to a deterministic synthetic
capacity-expansion-style sparse LP, so the solver path can always be
exercised.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.sparse as sp


def load_simple_cep_model(path: Optional[str] = None):
    """(c, A_ub, A_eq, b_ub, b_eq) of the instance at ``path`` (default:
    ``weights/energy_system/simple_cep_model_20220916/esm_instance.mat``),
    or of ``synthetic_cep_model()`` when there is no such file."""
    if path is None:
        from ..proxfn.pnp.hub import WEIGHTS_DIR

        path = os.path.join(WEIGHTS_DIR, "energy_system", "simple_cep_model_20220916",
                            "esm_instance.mat")
    if path is None or not os.path.exists(path):
        return synthetic_cep_model()
    from scipy import io

    m = io.loadmat(path)
    A = m["A"].astype(np.float64)
    b = m["rhs"].astype(np.float64)
    types = m["sense"]
    A_ub = A[types == "<"]
    b_ub = b[types == "<"][:, 0]
    A_eq = A[types == "="]
    b_eq = b[types == "="][:, 0]
    c = m["obj"][:, 0]
    return c, A_ub, A_eq, b_ub, b_eq


def synthetic_cep_model(n_periods: int = 64, n_tech: int = 8, seed: int = 0):
    """Deterministic sparse LP with capacity/demand structure:

    min c^T x  s.t.  generation meets demand (eq), generation bounded by
    installed capacity (ub), x >= 0. Variables: [capacity per tech,
    generation per tech per period].
    """
    rng = np.random.RandomState(seed)
    n_var = n_tech + n_tech * n_periods
    cap_cost = rng.uniform(50, 150, n_tech)
    gen_cost = rng.uniform(1, 20, n_tech)
    c = np.concatenate([cap_cost, np.tile(gen_cost, n_periods)])

    demand = 50 + 20 * np.sin(np.linspace(0, 6 * np.pi, n_periods)) + rng.rand(n_periods) * 5

    rows, cols, vals = [], [], []
    # equality: sum_t gen[t, p] == demand[p]
    for p in range(n_periods):
        for t in range(n_tech):
            rows.append(p)
            cols.append(n_tech + p * n_tech + t)
            vals.append(1.0)
    A_eq = sp.csr_matrix((vals, (rows, cols)), shape=(n_periods, n_var))
    b_eq = demand

    # inequality: gen[t, p] - avail[t] * cap[t] <= 0
    rows, cols, vals = [], [], []
    avail = rng.uniform(0.5, 1.0, (n_tech, n_periods))
    r = 0
    for p in range(n_periods):
        for t in range(n_tech):
            rows.append(r)
            cols.append(n_tech + p * n_tech + t)
            vals.append(1.0)
            rows.append(r)
            cols.append(t)
            vals.append(-avail[t, p])
            r += 1
    A_ub = sp.csr_matrix((vals, (rows, cols)), shape=(r, n_var))
    b_ub = np.zeros(r)
    return c, A_ub, A_eq, b_ub, b_eq


def synthetic_cep_scenarios(n_periods: int = 64, n_tech: int = 8,
                            n_scenarios: int = 8, seed: int = 0,
                            demand_spread: float = 0.3):
    """Two-stage stochastic capacity expansion: shared first-stage
    capacity, scenario-varying demand.

    The constraint matrix is IDENTICAL across scenarios (availability and
    balance structure); only the demand rhs b_eq varies - the shape the
    consensus-ADMM path exploits (one equilibration, batched matvecs).

    Returns (c, A_ub, A_eq, b_ub, b_eq_s, shared_idx) with
    b_eq_s of shape (n_scenarios, n_periods) and shared_idx the indices
    of the first-stage (capacity) variables.
    """
    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(n_periods, n_tech, seed)
    rng = np.random.RandomState(seed + 1)
    # multiplicative demand spread + scenario-specific phase wiggle
    scale = 1.0 + demand_spread * (rng.rand(n_scenarios, 1) - 0.5) * 2
    wiggle = demand_spread * 10 * np.sin(
        np.linspace(0, 4 * np.pi, n_periods)[None]
        + rng.rand(n_scenarios, 1) * 2 * np.pi)
    b_eq_s = np.maximum(b_eq[None] * scale + wiggle, 1.0)
    shared_idx = np.arange(n_tech)
    return c, A_ub, A_eq, b_ub, b_eq_s, shared_idx


def extensive_form(c, A_ub, A_eq, b_ub, b_eq_s, shared_idx):
    """Deterministic equivalent of the scenario problem: one copy of the
    shared variables, per-scenario copies of the rest, scenario costs
    averaged. Ground truth for the consensus solver tests/benchmarks."""
    S = b_eq_s.shape[0]
    n = c.shape[0]
    shared = np.zeros(n, bool)
    shared[shared_idx] = True
    local = ~shared
    k, nl = int(shared.sum()), int(local.sum())
    A_ub = sp.csr_matrix(A_ub)
    A_eq = sp.csr_matrix(A_eq)
    Au_sh, Au_lo = A_ub[:, shared], A_ub[:, local]
    Ae_sh, Ae_lo = A_eq[:, shared], A_eq[:, local]

    # variable order: [z (k), x_local_1 .. x_local_S]
    A_ub_blocks = sp.hstack([sp.vstack([Au_sh] * S),
                             sp.block_diag([Au_lo] * S)])
    A_eq_blocks = sp.hstack([sp.vstack([Ae_sh] * S),
                             sp.block_diag([Ae_lo] * S)])
    b_ub_full = np.tile(b_ub, S)
    b_eq_full = b_eq_s.reshape(-1)
    c_full = np.concatenate([c[shared], np.tile(c[local] / S, S)])
    return c_full, A_ub_blocks, A_eq_blocks, b_ub_full, b_eq_full
