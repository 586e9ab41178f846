"""CQL: conservative Q-learning for offline continuous control — the port
of ``ray_tpu/rllib/cql.py``.

SAC's losses plus the conservative regularizer ``logsumexp Q(s,·) −
Q(s,a_data)`` that pushes down out-of-distribution action values,
trained purely from logged data: the port's
:class:`~ray_tpu_torch.rllib.sac.SACLearner` with ``cql_weight > 0``.
Checkpoints are the learner state as pickled numpy trees.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from .algorithm import AlgorithmConfig
from .offline_data import OfflineData
from .rl_module import RLModuleSpec
from .sac import SACLearner, SquashedGaussianModule

#: The file ``save_to_path`` writes under its directory.
STATE_FILE = "learner.torch.pkl"


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.lr = 3e-4
        self.tau = 0.005
        self.train_batch_size = 256
        self.updates_per_iteration = 200
        self.cql_weight = 5.0           # reference min_q_weight default
        self.cql_num_actions = 10
        self.target_entropy = None
        self.init_alpha = 1.0
        self.grad_clip = 40.0
        self.offline_data: Any = None
        self.obs_dim: Optional[int] = None
        self.action_dim: Optional[int] = None
        self.action_low = None
        self.action_high = None

    def offline(self, data, *, obs_dim: int, action_dim: int,
                action_low, action_high):
        self.offline_data = data
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.action_low = np.asarray(action_low, np.float32)
        self.action_high = np.asarray(action_high, np.float32)
        return self


class CQL:
    """Offline Algorithm surface: train() minibatches logged transitions
    through the conservative SAC learner; no env interaction."""

    def __init__(self, config: CQLConfig):
        if config.offline_data is None:
            raise ValueError("CQLConfig.offline(data, ...) is required")
        self.config = config
        self.data = OfflineData(config.offline_data, seed=config.seed)
        self.module_spec = RLModuleSpec(
            obs_dim=config.obs_dim, num_actions=config.action_dim,
            hidden=config.hidden, continuous=True,
            action_low=config.action_low, action_high=config.action_high,
            module_cls=SquashedGaussianModule)
        self.learner = SACLearner(
            self.module_spec, lr=config.lr, gamma=config.gamma,
            tau=config.tau, grad_clip=config.grad_clip,
            target_entropy=config.target_entropy,
            init_alpha=config.init_alpha, seed=config.seed,
            cql_weight=config.cql_weight,
            cql_num_actions=config.cql_num_actions, device=config.device)
        self.iteration = 0
        self._infer_module = None

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iteration):
            metrics = self.learner.update(
                self.data.sample(cfg.train_batch_size))
        self.iteration += 1
        metrics["training_iteration"] = self.iteration
        metrics["num_transitions"] = len(self.data)
        return metrics

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        # Same inference path as SAC rollouts: one squash/rescale
        # convention lives in SquashedGaussianModule only; weights
        # refresh on every call since the learner trains between calls.
        if self._infer_module is None:
            self._infer_module = SquashedGaussianModule(
                self.module_spec, seed=self.config.seed)
        self._infer_module.set_weights(self.learner.get_weights())
        return self._infer_module.forward_inference(
            np.asarray(obs, np.float32))

    def save_to_path(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, STATE_FILE), "wb") as f:
            pickle.dump(self.learner.get_state(), f)
        return path

    def restore_from_path(self, path: str):
        with open(os.path.join(path, STATE_FILE), "rb") as f:
            self.learner.set_state(pickle.load(f))

    def stop(self):
        pass
