"""Learners: gradient updates on an RLModule on a torch device — the port
of ``ray_tpu/rllib/learner.py``.

A learner holds its parameters and Adam state as tensors on one device
(``device=None`` is the card and raises without one; tests pass
``device="cpu"``) and runs its loss through autograd with products and
convolutions at full f32 (:func:`~ray_tpu_torch._private.device.full_f32`).
A :class:`LearnerGroup` is one local learner, or N learners on the ranks
of a :class:`~ray_tpu_torch._private.ranks.RankPool` (one process and
device each) whose full states are averaged after every update, as the
reference averages its remote learner actors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._private import tree
from .._private.device import DeviceLike, full_f32, resolve_device
from .._private.ranks import RankPool
from ._optim import Adam, value_and_grad
from .rl_module import (RLModuleSpec, module_forward, params_to_numpy,
                        params_to_torch)


def compute_gae(rewards, values, next_values, dones, truncateds, shape,
                gamma: float = 0.99, lam: float = 0.95, rho=None):
    """Generalized advantage estimation over time-major fragments.

    All inputs are flat [T*N]; ``shape=[T, N]``. Episode ends (done OR
    truncated) cut the recursion; terminated states bootstrap with 0 via
    next_values (runner zeroed them), truncated ones with V(s').

    ``rho`` (optional, flat [T*N]): clipped importance ratios
    π_cur(a|s)/π_behavior(a|s) for off-policy correction — V-trace-style:
    delta is weighted by ρ_t and the trace decays with c_t = λ·min(ρ_t, 1).
    """
    T, N = int(shape[0]), int(shape[1])
    r = rewards.reshape(T, N)
    v = values.reshape(T, N)
    nv = next_values.reshape(T, N)
    cut = (dones | truncateds).reshape(T, N)
    rho_m = None if rho is None else rho.reshape(T, N)
    adv = np.zeros((T, N), np.float32)
    last = np.zeros((N,), np.float32)
    for t in range(T - 1, -1, -1):
        delta = r[t] + gamma * nv[t] - v[t]
        if rho_m is not None:
            delta = rho_m[t] * delta
            c = lam * np.minimum(rho_m[t], 1.0)
        else:
            c = lam
        last = delta + gamma * c * last * (~cut[t])
        adv[t] = last
    vtarg = adv + v
    return adv.reshape(-1), vtarg.reshape(-1)


def take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(values, index[:, None], -1)[:, 0]``."""
    return values.gather(-1, index[:, None])[:, 0]


class PPOLearner:
    """Clipped-surrogate PPO with value + entropy terms."""

    def __init__(self, module_spec: RLModuleSpec, *,
                 lr: float = 3e-4, clip_param: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 grad_clip: float = 0.5, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = module_spec
        self.optimizer = Adam(lr, grad_clip=grad_clip)
        self.params = params_to_torch(module_spec.build(seed).params,
                                      self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.clip_param = clip_param
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff

    def _loss(self, params, batch):
        clip = self.clip_param
        logits, value = module_forward(self.spec, params, batch["obs"],
                                       torch)
        logp_all = torch.log_softmax(logits, -1)
        logp = take(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(ratio * adv,
                             torch.clip(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -surr.mean()
        vf_loss = torch.square(value - batch["value_targets"]).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = (policy_loss + self.vf_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "total_loss": total}

    def _step(self, batch) -> Dict[str, torch.Tensor]:
        (_, metrics), grads = value_and_grad(self._loss, self.params, batch)
        self.params, self.opt_state = self.optimizer.update(
            self.params, grads, self.opt_state)
        return metrics

    def update(self, batch: Dict[str, np.ndarray], *,
               minibatch_size: Optional[int] = None,
               num_epochs: int = 1,
               shuffle_seed: int = 0) -> Dict[str, float]:
        """Minibatch SGD over ``batch`` (host arrays, moved to the device
        once); the metrics of the last minibatch, as the reference's."""
        n = len(batch["obs"])
        minibatch_size = minibatch_size or n
        rng = np.random.default_rng(shuffle_seed)
        # advantage normalization (standard PPO practice)
        adv = batch["advantages"]
        batch = dict(batch)
        batch["advantages"] = ((adv - adv.mean())
                               / (adv.std() + 1e-8)).astype(np.float32)
        on_device = params_to_torch(batch, self.device)
        metrics = {}
        with full_f32():
            for _ in range(num_epochs):
                perm = torch.from_numpy(rng.permutation(n)).to(self.device)
                for lo in range(0, n, minibatch_size):
                    idx = perm[lo:lo + minibatch_size]
                    metrics = self._step(
                        {k: v[idx] for k, v in on_device.items()})
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights):
        self.params = params_to_torch(weights, self.device)

    def get_state(self):
        return {"params": params_to_numpy(self.params),
                "opt_state": params_to_numpy(self.opt_state)}

    def set_state(self, state):
        self.params = params_to_torch(state["params"], self.device)
        self.opt_state = params_to_torch(state["opt_state"], self.device)


def mean_state(states: Sequence[Any]) -> Any:
    """The leafwise mean of learner states (numpy trees), each leaf kept
    in its dtype (the int32 Adam count stays an int), as the reference's
    ``LearnerGroup.update`` averages them."""
    return tree.map_with_path(
        lambda _, *xs: np.mean(np.stack(xs), axis=0).astype(
            np.asarray(xs[0]).dtype), states[0], *states[1:])


# A rank process of a LearnerGroup holds its one learner here.
_RANK: Dict[str, Any] = {}


def _rank_build(factory: Callable, devices: Sequence[str]) -> None:
    _RANK["learner"] = factory(device=devices[dist.get_rank()])


def _rank_call(method: str, *args, only: Optional[int] = None):
    if only is not None and dist.get_rank() != only:
        return None
    return getattr(_RANK["learner"], method)(*args)


def _rank_update(shards: Sequence[Dict[str, np.ndarray]], kw: dict):
    learner = _RANK["learner"]
    metrics = learner.update(shards[dist.get_rank()], **kw)
    return metrics, learner.get_state()


class LearnerGroup:
    """One local learner (``num_learners=0``) or ``num_learners`` learners
    on the ranks of a :class:`RankPool`, with gradient-mean semantics
    (reference ``learner.py:168``).

    ``learner_factory(device=...)`` builds a learner; for ranks it must
    pickle (a class or a ``functools.partial`` of one). The local learner
    runs on ``device``; rank ``i`` on ``devices[i]`` (default: ``device``
    on every rank when that is the CPU, else cards ``0..N-1``; pass
    ``("cuda:0",) * N`` to share one card over gloo). Ranks start from
    rank 0's weights; after each update the batch's shards' states
    (parameters and Adam moments) are averaged and set on every rank."""

    def __init__(self, learner_factory: Callable[..., Any],
                 num_learners: int = 0, *, device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.local = None
        self.num_learners = int(num_learners)
        self._pool: Optional[RankPool] = None
        if self.num_learners == 0:
            self.local = learner_factory(device=device)
            return
        if devices is None and device is not None and \
                torch.device(device).type == "cpu":
            devices = ("cpu",) * self.num_learners
        self._pool = RankPool(self.num_learners, devices=devices)
        try:
            self._pool.run(_rank_build, learner_factory, self._pool.devices)
            # identical init: broadcast learner 0's weights
            self._pool.run(_rank_call, "set_weights",
                           self._pool.run(_rank_call, "get_weights",
                                          only=0)[0])
        except BaseException:
            self._pool.close()
            raise

    def update(self, batch: Dict[str, np.ndarray], **kw) -> Dict[str, float]:
        if self.local is not None:
            return self.local.update(batch, **kw)
        # shard the batch across learners; average the resulting learner
        # states (params + optimizer moments) after the step
        n = len(batch["obs"])
        k = self.num_learners
        per = n // k
        shards = []
        for i in range(k):
            lo, hi = i * per, ((i + 1) * per if i < k - 1 else n)
            shards.append({key: v[lo:hi] for key, v in batch.items()})
        results = self._pool.run(_rank_update, shards, kw)
        # Average the FULL learner state — params AND optimizer moments —
        # so Adam's moments stay consistent with the averaged weights.
        self._pool.run(_rank_call, "set_state",
                       mean_state([s for _, s in results]))
        metrics = [m for m, _ in results]
        return {k2: float(np.mean([m[k2] for m in metrics]))
                for k2 in metrics[0]}

    def _call(self, method: str, *args):
        if self.local is not None:
            return getattr(self.local, method)(*args)
        return self._pool.run(_rank_call, method, *args, only=0)[0]

    def get_weights(self):
        return self._call("get_weights")

    def get_state(self):
        return self._call("get_state")

    def set_state(self, state):
        if self.local is not None:
            return self.local.set_state(state)
        self._pool.run(_rank_call, "set_state", state)

    def stop(self):
        if self._pool is not None:
            self._pool.close()
