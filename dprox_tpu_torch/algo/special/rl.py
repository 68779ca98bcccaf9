"""RL-style automatic hyperparameter tuning.

Counterpart of dprox_tpu/algo/special/rl.py. A small conv policy looks at
the solver state every ``action_pack`` iterations and emits that pack's
rho schedule, one sigma schedule per psi fn and a stop probability. The
whole episode is differentiable, so ``train`` optimizes the policy by
backpropagation through the unrolled episodes; ``train_ddpg`` is the
model-free path (replay buffer, target networks, Polyak averaging).

The networks are ``nn.Module``s on NCHW input with the JAX package's flax
layout carried over (``utils/checkpoint.py::convnet_state_dict_from_flax``):
its ``SAME`` padding, asymmetric at stride 2 (0 before, 1 after on an even
size), is applied explicitly, so a carried policy emits the same
schedules. The policy and the critic live on the wrapped solver's device.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ...utils.checkpoint import convnet_state_dict_from_flax, load_flax_msgpack
from ...utils.misc import to_tensor
from ..base import Algorithm, params_to
from .training import load_checkpoint, save_checkpoint

def _pad_same(x, k: int, s: int):
    """flax's ``SAME`` padding of a k x k, stride-s convolution: out =
    ceil(n / s), the total padding max((out - 1) s + k - n, 0), the smaller
    half before."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _encode(convs, ob):
    """Stride-2 stem, residual blocks each followed by a 2 x 2 average
    pool, global mean: [B, features]."""
    x = torch.relu(convs[0](_pad_same(ob, 3, 2)))
    for i in range(1, len(convs), 2):
        r = torch.relu(convs[i](_pad_same(x, 3, 1)))
        r = convs[i + 1](_pad_same(r, 3, 1))
        x = F.avg_pool2d(torch.relu(x + r), 2, 2)
    return x.mean(dim=(2, 3))


def _convs(in_ch, features, blocks):
    return nn.ModuleList([nn.Conv2d(in_ch, features, 3, stride=2)]
                         + [nn.Conv2d(features, features, 3) for _ in range(2 * blocks)])


class ResNetPolicy(nn.Module):
    """obs [B, ob_dim, H, W] -> softplus-positive rho pack [B, action_pack],
    per-psi sigma packs [B, num_psi, action_pack] and a stop probability."""

    def __init__(self, ob_dim: int, num_psi: int, action_pack: int = 5, features: int = 64):
        super().__init__()
        self.num_psi, self.action_pack = num_psi, action_pack
        self.convs = _convs(ob_dim, features, 3)
        self.dense = nn.ModuleList([nn.Linear(features, 128), nn.Linear(128, action_pack),
                                    nn.Linear(128, num_psi * action_pack), nn.Linear(128, 1)])

    def forward(self, ob):
        h = torch.relu(self.dense[0](_encode(self.convs, ob)))
        rho = F.softplus(self.dense[1](h) - 2.0) + 1e-4
        sigmas = F.softplus(self.dense[2](h) - 4.0) + 1e-6
        return {"rho": rho, "sigmas": sigmas.reshape(-1, self.num_psi, self.action_pack),
                "idx_stop": torch.sigmoid(self.dense[3](h)[:, 0])}


class CriticNet(nn.Module):
    """Q(ob, action) for the DDPG path: the policy's encoder (two residual
    blocks) fused with the flat action after the global pool."""

    def __init__(self, ob_dim: int, action_dim: int, features: int = 64):
        super().__init__()
        self.convs = _convs(ob_dim, features, 2)
        self.dense = nn.ModuleList([nn.Linear(features + action_dim, 128), nn.Linear(128, 128),
                                    nn.Linear(128, 1)])

    def forward(self, ob, action_vec):
        h = torch.cat([_encode(self.convs, ob), action_vec], dim=1)
        h = torch.relu(self.dense[1](torch.relu(self.dense[0](h))))
        return self.dense[2](h)[:, 0]


def _seeded(seed: int, make: Callable[[], nn.Module]) -> nn.Module:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def _clipped_step(opt, loss, params, max_norm: float):
    """One optimizer step with the gradient scaled to global norm at most
    ``max_norm`` (optax's ``clip_by_global_norm``; no host read)."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p, g in zip(params, grads):
        p.grad = g * scale
    opt.step()


def polyak(target: nn.Module, online: nn.Module, tau: float):
    """target <- (1 - tau) target + tau online, parameter by parameter."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), online.parameters()):
            t.copy_((1 - tau) * t + tau * p)


def _psnr(x, gt):
    mse = torch.mean((x.real - gt) ** 2, dim=(1, 2, 3))
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


class AutoTuneSolver:
    """The policy network wrapped around a compiled solver.

    ``custom_policy_ob_pack_fn(variables, x0c, T, aux_state)`` builds the
    observation from channel 0 of each packed state block, channel 0 of
    x0, the constant plane it / max_episode_step and the caller's
    ``__aux__`` side channel (e.g. a noise level); the default concatenates
    the first three."""

    def __init__(self, solver: Algorithm, policy: str = "resnet", action_pack: int = 5,
                 ob_dim: Optional[int] = None, max_episode_step: int = 6,
                 custom_policy_ob_pack_fn: Optional[Callable] = None):
        if policy != "resnet":
            raise ValueError(f"unknown policy {policy!r}; available: 'resnet'")
        self.solver = solver
        self.device = solver.device
        self.action_pack = action_pack
        self.max_episode_step = max_episode_step
        self.custom_policy_ob_pack_fn = custom_policy_ob_pack_fn
        self.num_psi = max(1, len(solver.psi_fns))
        self.ob_dim = ob_dim if ob_dim is not None else solver.state_dim + 2
        self.policy = _seeded(0, lambda: ResNetPolicy(self.ob_dim, self.num_psi, action_pack))
        self.policy.to(self.device)

    @property
    def policy_params(self):
        """A copy of the policy's weights (``state_dict`` names)."""
        return {k: v.detach().clone() for k, v in self.policy.state_dict().items()}

    @policy_params.setter
    def policy_params(self, params):
        self.policy.load_state_dict(params)

    # ---------------------------------------------------------------- #

    def _x0(self, x0):
        return to_tensor(x0, batch=True, device=self.device).to(torch.float32)

    def _policy_ob(self, state, it: int, x0, aux_state=None):
        parts = torch.tensor_split(self.solver.pack(state), self.solver.state_dim, dim=1)
        variables = torch.cat([p[:, :1].real for p in parts], dim=1)
        x0c = to_tensor(x0, batch=True, device=self.device)[:, :1].real.to(torch.float32)
        B, _, H, W = variables.shape
        T = torch.full((B, 1, H, W), it / self.max_episode_step, device=self.device)
        if self.custom_policy_ob_pack_fn is not None:
            ob = self.custom_policy_ob_pack_fn(variables, x0c, T, aux_state)
        else:
            ob = torch.cat([variables, x0c, T], dim=1)
        return ob.to(torch.float32)

    def _act(self, ob, params=None):
        return self.policy(ob) if params is None else functional_call(self.policy, params, (ob,))

    def estimate(self, state, it, x0, params=None, aux_state=None):
        """(rhos [B, pack], one sigma schedule [B, pack] per psi fn, stop
        probability [B]) for the state at macro-step ``it``; ``params``:
        policy weights in place of the policy's own."""
        action = self._act(self._policy_ob(state, it, x0, aux_state), params)
        lams = [action["sigmas"][:, i] for i in range(len(self.solver.psi_fns))]
        return action["rho"], lams, action["idx_stop"]

    def _episode(self, policy_params, x0, solve_params=None, aux_state=None):
        x0 = self._x0(x0)
        solve_params = params_to(dict(solve_params or {}), self.device)
        state = self.solver.initialize(x0, solve_params)
        for i in range(self.max_episode_step):
            rhos, lams, _ = self.estimate(state, i, x0, policy_params, aux_state)
            state = self.solver.iters(state, rhos, lams, self.action_pack,
                                      params=solve_params, x_ref=x0)
        return state[0]

    def solve(self, x0, aux_state=None, params=None, solve_params=None, **kwargs):
        """The episode's x (complex for a complex state), without a graph.
        ``params``: policy weights; ``solve_params``: the solver's
        placeholder values (observations, masks, ...)."""
        with torch.no_grad():
            return self._episode(params, x0, solve_params, aux_state)

    # ---------------------------------------------------------------- #

    def train(self, dataset, epochs: int = 1, lr: float = 3e-4, log_every: int = 10,
              savedir: Optional[str] = None, loss_kind: str = "mse", eval_fn=None,
              eval_every: int = 0):
        """Policy optimization by backpropagation through solve episodes
        (``torch.optim.Adam``). ``dataset`` yields dicts with 'x0', 'gt',
        an optional '__aux__' for the observation and the solver's
        placeholder values. ``loss_kind``: 'mse' or 'logmse' (log-MSE
        weights easy and hard problems alike).

        ``eval_fn(params)`` every ``eval_every`` steps, and once at the
        end, scores held-out problems (higher is better); the
        best-scoring params are returned instead of the last ones, and
        ``savedir/policy.ckpt`` holds them with the optimizer state and
        step count they were taken at."""
        params = {k: v.detach().clone().requires_grad_() for k, v in self.policy_params.items()}
        opt = torch.optim.Adam(list(params.values()), lr=lr)

        def loss_fn(batch):
            aux = batch.get("__aux__")
            solve_params = {k: v for k, v in batch.items() if k not in ("x0", "gt", "__aux__")}
            out = self._episode(params, batch["x0"], solve_params, aux_state=aux)
            gt = to_tensor(batch["gt"], device=self.device)
            mse = torch.mean((out.real - gt) ** 2)
            return torch.log(mse + 1e-10) if loss_kind == "logmse" else mse

        def snapshot(score, step, epoch):
            return (score, {k: v.detach().clone() for k, v in params.items()},
                    copy.deepcopy(opt.state_dict()), step, epoch)

        step, best = 0, None  # best: (score, params, opt_state, step, epoch)
        for epoch in range(epochs):
            for batch in dataset:
                loss = loss_fn(batch)
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                for p, g in zip(params.values(), grads):  # the stop head gets no gradient
                    p.grad = torch.zeros_like(p) if g is None else g
                opt.step()
                step += 1
                if log_every and step % log_every == 0:
                    print(f"[autotune] epoch {epoch} step {step} loss {float(loss):.5f}")
                if eval_fn is not None and eval_every and step % eval_every == 0:
                    score = float(eval_fn({k: v.detach() for k, v in params.items()}))
                    if best is None or score > best[0]:
                        best = snapshot(score, step, epoch)
                    print(f"[autotune] step {step} heldout {score:+.3f} best {best[0]:+.3f}",
                          flush=True)
        if eval_fn is not None and eval_every:
            score = float(eval_fn({k: v.detach() for k, v in params.items()}))
            if best is None or score > best[0]:
                best = snapshot(score, step, epochs)
            print(f"[autotune] selected heldout {best[0]:+.3f}", flush=True)
            _, chosen, opt_state, step, epoch = best
        else:
            chosen = {k: v.detach().clone() for k, v in params.items()}
            opt_state, epoch = opt.state_dict(), epochs
        self.policy_params = chosen
        if savedir:
            save_checkpoint(f"{savedir}/policy.ckpt", chosen, opt_state, epoch, step, 0.0)
        return chosen

    # ------------------------------------------------------------------ #
    # Model-free DDPG path
    # ------------------------------------------------------------------ #

    def _flat_action(self, action):
        B = action["rho"].shape[0]
        return torch.cat([action["rho"].reshape(B, -1), action["sigmas"].reshape(B, -1),
                          action["idx_stop"].reshape(B, 1)], dim=1)

    def _action_from_flat(self, vec):
        pack, npsi = self.action_pack, self.num_psi
        return {"rho": torch.clamp_min(vec[:, :pack], 1e-6),
                "sigmas": torch.clamp_min(vec[:, pack:pack + npsi * pack], 1e-8).reshape(
                    -1, npsi, pack),
                "idx_stop": torch.clamp(vec[:, -1], 0.0, 1.0)}

    def critic_update(self, critic, critic_opt, actor_target, critic_target, batch,
                      gamma: float, ymax: float, grad_clip: float):
        """One clipped Adam step of the critic on the TD target
        rew + gamma (1 - done) Q'(nob, pi'(nob)), clamped to +-ymax."""
        with torch.no_grad():
            na = self._flat_action(actor_target(batch["nob"]))
            y = batch["rew"] + gamma * (1.0 - batch["done"]) * critic_target(batch["nob"], na)
            y = torch.clamp(y, -ymax, ymax)
        loss = torch.mean((critic(batch["ob"], batch["act"]) - y) ** 2)
        _clipped_step(critic_opt, loss, list(critic.parameters()), grad_clip)
        return loss.detach()

    def actor_update(self, actor_opt, critic, ob, grad_clip: float):
        """One clipped Adam step of the policy on -mean Q(ob, pi(ob))."""
        loss = -torch.mean(critic(ob, self._flat_action(self.policy(ob))))
        _clipped_step(actor_opt, loss, list(self.policy.parameters()), grad_clip)
        return loss.detach()

    def train_ddpg(self, dataset, epochs: int = 1, actor_lr: float = 1e-4,
                   critic_lr: float = 3e-4, gamma: float = 0.99, tau: float = 0.005,
                   noise_scale: float = 0.05, batch_size: int = 16, buffer_size: int = 2048,
                   warmup: int = 8, updates_per_step: int = 1, loop_penalty: float = 0.05,
                   reward_clip: float = 10.0, grad_clip: float = 1.0, log_every: int = 0,
                   seed: int = 0):
        """Off-policy DDPG: the reward of a macro-step is its PSNR gain less
        ``loop_penalty``, clipped to +-``reward_clip``; the horizon is
        terminal. Exploration noise and replay sampling draw from
        ``np.random.RandomState(seed)``, the critic's initial weights from
        torch's generator seeded with ``seed``. Returns the trained policy
        params (also the policy's own)."""
        rng = np.random.RandomState(seed)
        dataset = list(dataset)

        def prep(sample):
            x0 = self._x0(sample["x0"])
            gt = to_tensor(sample["gt"], batch=True, device=self.device).to(
                torch.float32).reshape(x0.shape)
            sp = params_to({k: v for k, v in sample.items() if k not in ("x0", "gt")},
                           self.device)
            return x0, gt, sp

        x0, _, sp = prep(dataset[0])
        with torch.no_grad():
            ob0 = self._policy_ob(self.solver.initialize(x0, sp), 0, x0)
            a0 = self._flat_action(self.policy(ob0))
        critic = _seeded(seed, lambda: CriticNet(ob0.shape[1], a0.shape[1])).to(self.device)
        actor_target, critic_target = copy.deepcopy(self.policy), copy.deepcopy(critic)
        actor_opt = torch.optim.Adam(self.policy.parameters(), lr=actor_lr)
        critic_opt = torch.optim.Adam(critic.parameters(), lr=critic_lr)
        ymax = reward_clip * self.max_episode_step
        buf = {"ob": [], "act": [], "rew": [], "nob": [], "done": []}

        step = 0
        for epoch in range(epochs):
            for sample in dataset:
                x0, gt, sp = prep(sample)
                with torch.no_grad():
                    state = self.solver.initialize(x0, sp)
                    ob, last_psnr = self._policy_ob(state, 0, x0), _psnr(state[0], gt)
                for i in range(self.max_episode_step):
                    noise = torch.as_tensor(noise_scale * rng.randn(*a0.shape),
                                            dtype=torch.float32, device=self.device)
                    with torch.no_grad():
                        a = self._flat_action(self.policy(ob)) + noise
                        action = self._action_from_flat(a)
                        lams = [action["sigmas"][:, j] for j in range(len(self.solver.psi_fns))]
                        state = self.solver.iters(tuple(state), action["rho"], lams,
                                                  self.action_pack, params=sp, x_ref=x0)
                        new_psnr, nob = _psnr(state[0], gt), self._policy_ob(state, i + 1, x0)
                    rew = torch.clamp(new_psnr - last_psnr - loop_penalty, -reward_clip,
                                      reward_clip)
                    last_psnr = new_psnr
                    # the horizon ends the episode: returns are bounded by the
                    # H-step reward sum
                    done = torch.full((ob.shape[0],), float(i == self.max_episode_step - 1),
                                      device=self.device)
                    for k, v in zip(buf, (ob, a, rew, nob, done)):
                        buf[k] = (buf[k] + list(v.unbind(0)))[-buffer_size:]
                    ob = nob
                    step += 1
                    if len(buf["ob"]) < max(warmup, batch_size):
                        continue
                    for _ in range(updates_per_step):
                        idx = rng.randint(0, len(buf["ob"]), batch_size)
                        batch = {k: torch.stack([v[j] for j in idx]) for k, v in buf.items()}
                        c_loss = self.critic_update(critic, critic_opt, actor_target,
                                                    critic_target, batch, gamma, ymax, grad_clip)
                        a_loss = self.actor_update(actor_opt, critic, batch["ob"], grad_clip)
                        polyak(actor_target, self.policy, tau)
                        polyak(critic_target, critic, tau)
                        if log_every and step % log_every == 0:
                            print(f"[ddpg] step {step} critic {float(c_loss):.4f} "
                                  f"actor {float(a_loss):.4f}")
        return self.policy_params

    def load(self, path: str):
        """Policy weights from a ``.msgpack`` of the JAX package's flax
        params (the shipped ``weights/autotune_*.msgpack``) or a checkpoint
        of ``train``."""
        if str(path).endswith(".msgpack"):
            self.policy_params = convnet_state_dict_from_flax(load_flax_msgpack(path))
        else:
            self.policy_params = load_checkpoint(path)[0]
