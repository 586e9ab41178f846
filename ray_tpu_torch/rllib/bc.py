"""BC: behavior cloning from offline data — the port of
``ray_tpu/rllib/bc.py``.

Supervised negative log-likelihood on logged (obs, action) pairs, Adam
(optax's, no clipping) on the learner's device (``BCConfig.learners(
device=...)``; the card unless told otherwise); no env interaction.
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


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BC
        self.offline_data: Any = None   # Dataset | list[dict] | dict of cols
        self.obs_dim: Optional[int] = None
        self.num_actions: Optional[int] = None

    def offline(self, data, *, obs_dim: int, num_actions: int):
        self.offline_data = data
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        return self


class BC:
    """Offline supervised policy learning; env-free Algorithm surface."""

    def __init__(self, config: BCConfig):
        if config.offline_data is None:
            raise ValueError("BCConfig.offline(data, ...) is required")
        self.config = config
        self.device = resolve_device(config.device)
        self._cols = to_columns(config.offline_data, keys=("obs", "actions"),
                                discrete_actions=True)
        self.module_spec = RLModuleSpec(
            obs_dim=config.obs_dim, num_actions=config.num_actions,
            hidden=config.hidden)
        self.params = params_to_torch(
            self.module_spec.build(config.seed).params, self.device)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.iteration = 0
        self._rng = np.random.default_rng(config.seed)

    def _loss(self, params, batch):
        logits, _ = module_forward(self.module_spec, params, batch["obs"],
                                   torch)
        nll = -take(torch.log_softmax(logits, -1), batch["actions"])
        return nll.mean(), {}

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._cols["obs"])
        bs = min(cfg.minibatch_size, n)
        cols = params_to_torch(self._cols, self.device)
        loss = None
        with full_f32():
            for _ in range(cfg.num_epochs):
                perm = torch.from_numpy(self._rng.permutation(n)).to(
                    self.device)
                for lo in range(0, n, bs):
                    idx = perm[lo:lo + bs]
                    (loss, _), grads = value_and_grad(
                        self._loss, self.params,
                        {k: v[idx] for k, v in cols.items()})
                    self.params, self.opt_state = self.optimizer.update(
                        self.params, grads, self.opt_state)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "bc_loss": float(loss)}

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        logits, _ = module_forward(
            self.module_spec, params_to_numpy(self.params),
            np.asarray(obs, np.float32), np)
        return logits.argmax(-1)

    def stop(self):
        pass
