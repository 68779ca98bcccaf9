"""Hyperparameter schedules: DPIR-style log-space descent.

Counterpart of dprox_tpu/algo/tune.py (``log_descent``,
``get_rho_sigma_admm``).
"""
from __future__ import annotations

import numpy as np
import torch


def log_descent(upper, lower, iter: int = 24, sigma: float = 0.255 / 255,
                w: float = 1.0, lam: float = 0.23, sqrt: bool = False):
    """Per-iteration (rhos, sigmas) schedules as float32 CPU tensors of
    length ``iter`` (solvers move them to their device); sigmas are
    squared unless ``sqrt=True``."""
    modelSigmaS = np.logspace(np.log10(upper), np.log10(lower), iter).astype(np.float32)
    modelSigmaS_lin = np.linspace(upper, lower, iter).astype(np.float32)
    sigmas = (modelSigmaS * w + modelSigmaS_lin * (1 - w)) / 255.0
    rhos = np.array([lam * (sigma**2) / (s**2) for s in sigmas], np.float32)
    if not sqrt:
        sigmas = sigmas**2
    return torch.from_numpy(rhos), torch.from_numpy(sigmas.astype(np.float32))


def get_rho_sigma_admm(sigma=2.55 / 255, iter_num=15, modelSigma1=49.0,
                       modelSigma2=2.55, w=1.0, lam=0.23):
    """DPIR's (rhos, sigmas) for ``iter_num`` iterations as float32 CPU
    tensors; sigmas are not squared."""
    modelSigmaS = np.logspace(np.log10(modelSigma1), np.log10(modelSigma2),
                              iter_num).astype(np.float32)
    modelSigmaS_lin = np.linspace(modelSigma1, modelSigma2, iter_num).astype(np.float32)
    sigmas = (modelSigmaS * w + modelSigmaS_lin * (1 - w)) / 255.0
    rhos = [lam * (sigma**2) / (s**2) for s in sigmas]
    return torch.from_numpy(np.array(rhos, np.float32)), torch.from_numpy(sigmas)
