"""DQN: replay + target network + double-Q loss — the port of
``ray_tpu/rllib/dqn.py``.

``training_step``: sample → store → replay-sample → TD update on the
learner's device → target sync → priority update. The epsilon-greedy
rollout module (numpy) and the replay buffers are copied.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from .._private import tree
from .._private.device import DeviceLike, full_f32, resolve_device
from ._optim import Adam, value_and_grad
from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup, take
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .rl_module import (DiscreteMLPModule, module_forward, params_to_numpy,
                        params_to_torch)


class EpsilonGreedyModule(DiscreteMLPModule):
    """Q-network module: exploration is epsilon-greedy over argmax-Q.

    The "value" head doubles as nothing here — Q-values come from the
    logits head; GAE columns produced by the env runner are ignored by
    the DQN learner.
    """

    def __init__(self, spec, seed: int = 0):
        if spec.conv:
            from .conv_module import init_conv_params

            self.spec = spec
            self.params = init_conv_params(spec, seed)
        else:
            super().__init__(spec, seed)
        self.epsilon = 1.0

    def forward_inference(self, obs: np.ndarray):
        q, _ = module_forward(self.spec, self.params, obs, np)
        return q.argmax(-1)

    def forward_values(self, obs: np.ndarray) -> np.ndarray:
        _, value = module_forward(self.spec, self.params, obs, np)
        return value

    def forward_exploration(self, obs: np.ndarray,
                            rng: np.random.Generator):
        q, value = module_forward(self.spec, self.params, obs, np)
        greedy = q.argmax(-1)
        explore = rng.random(len(greedy)) < self.epsilon
        random_a = rng.integers(0, q.shape[-1], len(greedy))
        actions = np.where(explore, random_a, greedy)
        # logp is meaningless for value-based exploration; fill zeros.
        return actions, np.zeros(len(actions), np.float32), value

    def set_weights(self, params):
        # Epsilon rides along with weight broadcasts (the algorithm owns
        # the schedule; runners just apply it).
        if isinstance(params, dict) and "__epsilon__" in params:
            params = dict(params)
            self.epsilon = float(params.pop("__epsilon__"))
        super().set_weights(params)


class DQNLearner:
    """Double-DQN TD step with a periodically synced target net."""

    def __init__(self, module_spec, *, lr: float = 1e-3,
                 gamma: float = 0.99, grad_clip: float = 10.0,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = module_spec
        self.gamma = gamma
        self.optimizer = Adam(lr, grad_clip=grad_clip)
        params = module_spec.build(seed).params
        self.params = params_to_torch(params, self.device)
        self.target_params = params_to_torch(params, self.device)
        self.opt_state = self.optimizer.init(self.params)

    def _loss(self, params, batch):
        spec = self.spec
        q, _ = module_forward(spec, params, batch["obs"], torch)
        q_taken = take(q, batch["actions"])
        # double DQN: online net picks a', target net evaluates it; the
        # target carries no gradient
        with torch.no_grad():
            q_next_online, _ = module_forward(spec, params,
                                              batch["next_obs"], torch)
            a_prime = q_next_online.argmax(-1)
            q_next_target, _ = module_forward(spec, self.target_params,
                                              batch["next_obs"], torch)
            q_prime = take(q_next_target, a_prime)
            target = batch["rewards"] + self.gamma * q_prime * \
                (1.0 - batch["dones"])
        td = q_taken - target
        weights = batch.get("weights")
        w = weights if weights is not None else torch.ones_like(td)
        loss = torch.mean(w * torch.square(td))
        return loss, {"td_errors": td, "qf_loss": loss,
                      "q_mean": q_taken.mean()}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        feed = {
            "obs": batch["obs"].astype(np.float32),
            "actions": batch["actions"].astype(np.int64),
            "rewards": batch["rewards"].astype(np.float32),
            "next_obs": batch["next_obs"].astype(np.float32),
            "dones": batch["dones"].astype(np.float32),
        }
        if "weights" in batch:
            feed["weights"] = batch["weights"].astype(np.float32)
        with full_f32():
            (_, aux), grads = value_and_grad(
                self._loss, self.params, params_to_torch(feed, self.device))
            self.params, self.opt_state = self.optimizer.update(
                self.params, grads, self.opt_state)
        td = aux.pop("td_errors").cpu().numpy()
        out = {k: float(v) for k, v in aux.items()}
        out["td_errors"] = td
        return out

    def sync_target(self):
        self.target_params = tree.map_with_path(lambda _, p: p.clone(),
                                                self.params)

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights):
        self.params = params_to_torch(weights, self.device)

    def get_state(self):
        return {"params": params_to_numpy(self.params),
                "target": params_to_numpy(self.target_params),
                "opt_state": params_to_numpy(self.opt_state)}

    def set_state(self, state):
        self.params = params_to_torch(state["params"], self.device)
        self.target_params = params_to_torch(state["target"], self.device)
        self.opt_state = params_to_torch(state["opt_state"], self.device)

    def update_full(self, batch, **kw):
        return self.update(batch)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DQN
        self.lr = 1e-3
        self.train_batch_size = 32
        self.replay_capacity = 50_000
        self.num_steps_sampled_before_learning = 1000
        self.target_update_freq = 500      # learner updates between syncs
        self.updates_per_iteration = 64
        self.prioritized_replay = True
        self.replay_alpha = 0.6
        self.replay_beta = 0.4
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000
        self.rollout_fragment_length = 64


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        self._replay = None
        super().__init__(config)

    def _make_module_spec(self, config):
        spec = config.module_spec()
        spec.module_cls = EpsilonGreedyModule
        return spec

    def _build_learner_group(self):
        cfg = self.config
        spec = self.module_spec
        if cfg.prioritized_replay:
            self._replay = PrioritizedReplayBuffer(
                cfg.replay_capacity, alpha=cfg.replay_alpha,
                beta=cfg.replay_beta, seed=cfg.seed)
        else:
            self._replay = ReplayBuffer(cfg.replay_capacity, seed=cfg.seed)
        group = LearnerGroup(functools.partial(
            DQNLearner, spec, lr=cfg.lr, gamma=cfg.gamma,
            grad_clip=cfg.grad_clip, seed=cfg.seed), device=cfg.device)
        self._learner = group.local
        self._updates = 0
        return group

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps /
                   max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # 1. sample and store
        for batch in self.env_runner_group.sample():
            n = len(batch)
            self._timesteps += n
            self._replay.add({
                "obs": batch["obs"], "actions": batch["actions"],
                "rewards": batch["rewards"],
                "next_obs": batch["next_obs"],
                "dones": (batch["dones"].astype(np.float32)),
            })
        metrics: Dict[str, Any] = {}
        # 2. replay updates once warm
        if len(self._replay) >= cfg.num_steps_sampled_before_learning:
            for _ in range(cfg.updates_per_iteration):
                sample = self._replay.sample(cfg.train_batch_size)
                out = self._learner.update(sample)
                td = out.pop("td_errors")
                if hasattr(self._replay, "update_priorities"):
                    self._replay.update_priorities(sample["_indices"], td)
                metrics = out
                self._updates += 1
                if self._updates % cfg.target_update_freq == 0:
                    self._learner.sync_target()
        # 3. broadcast weights + fresh epsilon to runners
        w = dict(self._learner.get_weights())
        w["__epsilon__"] = self._epsilon()
        self.env_runner_group.sync_weights(w)
        metrics["epsilon"] = self._epsilon()
        metrics["replay_size"] = len(self._replay)
        metrics["num_updates"] = self._updates
        return metrics
