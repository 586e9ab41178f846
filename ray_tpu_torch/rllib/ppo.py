"""PPO — the port of ``ray_tpu/rllib/ppo.py``: synchronous on-policy
sampling, GAE, clipped-surrogate minibatch SGD on the learner group,
weight broadcast to the env runner.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np

from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup, PPOLearner, compute_gae


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = PPO

    def build(self) -> "Algorithm":
        if self.policies:  # .multi_agent(...) was called
            from .multi_agent import MultiAgentPPO

            return MultiAgentPPO(self)
        return PPO(self)


class PPO(Algorithm):
    def _build_learner_group(self) -> LearnerGroup:
        cfg = self.config
        factory = functools.partial(
            PPOLearner, self.module_spec, lr=cfg.lr,
            clip_param=cfg.clip_param, vf_coeff=cfg.vf_coeff,
            entropy_coeff=cfg.entropy_coeff, grad_clip=cfg.grad_clip,
            seed=cfg.seed)
        return LearnerGroup(factory, num_learners=cfg.num_learners,
                            device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # 1. sample until train_batch_size env steps are collected
        fragments = []
        collected = 0
        while collected < cfg.train_batch_size:
            for batch in self.env_runner_group.sample():
                fragments.append(batch)
                collected += len(batch)
        self._timesteps += collected

        # 2. GAE per fragment (episode structure is per-fragment)
        cols = {k: [] for k in ("obs", "actions", "logp_old",
                                "advantages", "value_targets")}
        for frag in fragments:
            adv, vtarg = compute_gae(
                frag["rewards"], frag["values"], frag["next_values"],
                frag["dones"], frag["truncateds"], frag["_shape"],
                gamma=cfg.gamma, lam=cfg.lam)
            cols["obs"].append(frag["obs"])
            cols["actions"].append(frag["actions"])
            cols["logp_old"].append(frag["logp"])
            cols["advantages"].append(adv)
            cols["value_targets"].append(vtarg)
        train_batch = {k: np.concatenate(v).astype(
            np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}

        # 3. minibatch SGD epochs on the learner group
        metrics = self.learner_group.update(
            train_batch, minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs, shuffle_seed=self.iteration)

        # 4. broadcast fresh weights to the env runner
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_trained"] = collected
        return metrics
