"""Shared supervised training loop with checkpoint and resume.

Counterpart of dprox_tpu/algo/special/training.py: AdamW (``torch.optim``
in place of optax), per-epoch evaluation with best-checkpoint tracking,
and a ``last.ckpt`` that resumes params, optimizer state, epoch, step and
best score. Checkpoints are ``torch.save`` files of the param tree (nested
dicts, lists and tuples of tensors) and the optimizer's ``state_dict``.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def save_checkpoint(path: str, params, opt_state, epoch: int, gstep: int, best_psnr: float):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, spec = tree_flatten(params)
    params = tree_unflatten([t.detach().cpu() if isinstance(t, torch.Tensor) else t
                             for t in leaves], spec)
    torch.save({"params": params, "opt_state": opt_state, "epoch": epoch, "gstep": gstep,
                "best_psnr": best_psnr}, path)


def load_checkpoint(path: str, map_location="cpu"):
    """``(params, opt_state, epoch, gstep, best_psnr)`` of a checkpoint."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return blob["params"], blob["opt_state"], blob["epoch"], blob["gstep"], blob["best_psnr"]


def trainable(params):
    """``(leaves, spec)``: copies of ``params``' leaves as new float
    tensors that require grad, each where its leaf was (numbers and numpy
    arrays on the CPU), and the tree structure that
    ``tree_unflatten(leaves, spec)`` rebuilds."""
    leaves, spec = tree_flatten(params)
    return [torch.as_tensor(t).detach().clone().float().requires_grad_() for t in leaves], spec


def zero_nonfinite_(loss, leaves):
    """The NaN guard: where the loss or any gradient is not finite, every
    gradient becomes 0 (the optimizer still steps, so Adam's moments decay
    and the decoupled weight decay still moves the params, as optax's
    masked update does). No host read."""
    finite = torch.isfinite(loss)
    for t in leaves:
        finite = finite & torch.isfinite(t.grad).all()
    for t in leaves:
        t.grad.copy_(torch.where(finite, t.grad, torch.zeros_like(t.grad)))


def train_supervised(step_fn: Callable, dataset: Iterable, init_params, epochs: int = 10,
                     lr: float = 1e-4, weight_decay: float = 1e-4,
                     savedir: Optional[str] = None, resume: bool = False,
                     eval_fn: Optional[Callable] = None, log_every: int = 50, seed: int = 0):
    """``step_fn(params, batch, generator) -> loss`` with ``params`` in
    ``init_params``' structure and a ``torch.Generator`` seeded from
    ``seed`` (where the JAX package hands a PRNG key). Returns the trained
    params (detached). ``eval_fn(params) -> psnr`` drives best-checkpoint
    tracking once an epoch."""
    leaves, spec = trainable(init_params)
    opt = torch.optim.AdamW(leaves, lr=lr, weight_decay=weight_decay)
    start_epoch, gstep, best_psnr = 0, 0, -np.inf

    ckpt_last = os.path.join(savedir, "last.ckpt") if savedir else None
    if resume and ckpt_last and os.path.exists(ckpt_last):
        params, opt_state, start_epoch, gstep, best_psnr = load_checkpoint(ckpt_last)
        with torch.no_grad():
            for t, v in zip(leaves, tree_flatten(params)[0]):
                t.copy_(v)
        opt.load_state_dict(opt_state)

    def current():
        return tree_unflatten(leaves, spec)

    generator = torch.Generator().manual_seed(seed)
    for epoch in range(start_epoch, epochs):
        losses = []
        for batch in dataset:
            loss = step_fn(current(), batch, generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for t, g in zip(leaves, grads):
                t.grad = torch.zeros_like(t) if g is None else g
            zero_nonfinite_(loss.detach(), leaves)
            opt.step()
            losses.append(loss.detach())
            gstep += 1
            if log_every and gstep % log_every == 0:
                recent = torch.stack(losses[-log_every:]).mean()
                print(f"epoch {epoch} step {gstep} loss {float(recent):.5f}")
        if eval_fn is not None:
            with torch.no_grad():
                psnr = float(eval_fn(current()))
            if psnr > best_psnr:
                best_psnr = psnr
                if savedir:
                    save_checkpoint(os.path.join(savedir, "best.ckpt"), current(),
                                    opt.state_dict(), epoch, gstep, best_psnr)
        if savedir:
            save_checkpoint(ckpt_last, current(), opt.state_dict(), epoch + 1, gstep, best_psnr)
    return tree_unflatten([t.detach() for t in leaves], spec)
