"""MARWIL: monotonic advantage re-weighted imitation learning — the port
of ``ray_tpu/rllib/marwil.py``.

Behavior cloning weighted by ``exp(beta * advantage)``, with a learned
value baseline and a running normalizer of the advantage scale (beta=0
is plain BC). One step updates policy and value heads together on the
learner's device; the normalizer ``ms_adv`` is carried from step to step
as the reference's learner state.

Offline data needs ``obs, actions, rewards, dones`` columns; Monte-Carlo
returns are computed once at load.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._private.device import full_f32, resolve_device
from ._optim import Adam, value_and_grad
from .algorithm import AlgorithmConfig
from .learner import take
from .offline_data import to_columns
from .rl_module import (RLModuleSpec, module_forward, params_to_numpy,
                        params_to_torch)


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0               # 0 → plain behavior cloning
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2
        self.offline_data: Any = None
        self.obs_dim: Optional[int] = None
        self.num_actions: Optional[int] = None

    def offline(self, data, *, obs_dim: int, num_actions: int):
        self.offline_data = data
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        return self


def _monte_carlo_returns(rewards, dones, gamma):
    out = np.zeros_like(rewards, np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        acc = rewards[i] + gamma * acc * (1.0 - dones[i])
        out[i] = acc
    return out


class MARWIL:
    """Offline Algorithm surface (env-free)."""

    def __init__(self, config: MARWILConfig):
        if config.offline_data is None:
            raise ValueError("MARWILConfig.offline(data, ...) is required")
        self.config = config
        self.device = resolve_device(config.device)
        cols = to_columns(config.offline_data,
                          keys=("obs", "actions", "rewards", "dones"),
                          discrete_actions=True)
        cols["returns"] = _monte_carlo_returns(
            cols["rewards"], cols["dones"], config.gamma)
        self._cols = cols
        self.module_spec = RLModuleSpec(
            obs_dim=config.obs_dim, num_actions=config.num_actions,
            hidden=config.hidden)
        self.params = params_to_torch(
            self.module_spec.build(config.seed).params, self.device)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        # Running ||A||² normalizer (a learner state variable updated
        # with a small rate), kept on the device.
        self._ms_adv = torch.tensor(1.0, dtype=torch.float32,
                                    device=self.device)
        self.iteration = 0
        self._rng = np.random.default_rng(config.seed)

    def _loss(self, params, batch, ms_adv):
        cfg = self.config
        logits, value = module_forward(self.module_spec, params,
                                       batch["obs"], torch)
        adv = batch["returns"] - value
        # normalize the exponent by the running advantage scale so
        # exp() stays in range regardless of reward magnitude
        weight = (torch.exp(cfg.beta * adv / torch.sqrt(ms_adv + 1e-8))
                  if cfg.beta else torch.ones_like(adv))
        weight = torch.clip(weight, 0.0, 20.0).detach()
        nll = -take(torch.log_softmax(logits, -1), batch["actions"])
        policy_loss = torch.mean(weight * nll)
        vf_loss = torch.mean(adv ** 2)
        rate = cfg.moving_average_sqd_adv_norm_update_rate
        new_ms = ms_adv + rate * (torch.mean(adv.detach() ** 2) - ms_adv)
        loss = policy_loss + cfg.vf_coeff * vf_loss
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "weight_mean": weight.mean(), "ms_adv": new_ms}

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._cols["obs"])
        bs = min(cfg.minibatch_size, n)
        cols = params_to_torch(self._cols, self.device)
        aux = {}
        with full_f32():
            for _ in range(cfg.num_epochs):
                perm = torch.from_numpy(self._rng.permutation(n)).to(
                    self.device)
                for lo in range(0, n, bs):
                    idx = perm[lo:lo + bs]
                    (_, aux), grads = value_and_grad(
                        self._loss, self.params,
                        {k: v[idx] for k, v in cols.items()}, self._ms_adv)
                    self.params, self.opt_state = self.optimizer.update(
                        self.params, grads, self.opt_state)
                    self._ms_adv = aux["ms_adv"]
        self.iteration += 1
        out = {k: float(v) for k, v in aux.items()}
        out["training_iteration"] = self.iteration
        return out

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        logits, _ = module_forward(
            self.module_spec, params_to_numpy(self.params),
            np.asarray(obs, np.float32), np)
        return logits.argmax(-1)

    def stop(self):
        pass
