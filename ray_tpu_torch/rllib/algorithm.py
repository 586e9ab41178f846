"""Algorithm + AlgorithmConfig — the port of ``ray_tpu/rllib/algorithm.py``:
sample → learn → sync-weights iterations on one host (env runners local
or on runner threads), learners on a torch device
(``AlgorithmConfig.learners(device=...)``; the card unless told
otherwise).

The config is copied, with the learners' device in place of the
reference's ``mesh``. Environments are made in-process, from
``env_creator`` or by name through gymnasium, which is imported only
then. Checkpoints are the port's own: the learner state as pickled numpy
trees (the reference's ``algo_state.pkl`` pickles optax objects and does
not cross). ``as_trainable`` (Tune) stays with the runtime.
"""
from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup
from .rl_module import RLModuleSpec

#: The file ``save_to_path`` writes under its directory.
STATE_FILE = "algo_state.torch.pkl"


class AlgorithmConfig:
    """Fluent config (reference ``algorithm_config.py``): each section
    method sets its fields and returns the config."""

    def __init__(self):
        self.env: Optional[str] = None
        self.env_creator: Optional[Callable] = None
        self.num_env_runners = 0
        self.num_envs_per_runner = 1
        self.rollout_fragment_length = 200
        self.num_learners = 0
        self.lr = 3e-4
        self.gamma = 0.99
        self.lam = 0.95
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 8
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 0.5
        self.hidden = (64, 64)
        self.seed = 0
        self.device = None              # learners' device; None: the card
        self.use_conv = False           # CNN torso (image observations)
        self.env_to_module_connector: Optional[Callable] = None
        # multi-agent (None ⇒ single-agent; see multi_agent.py)
        self.policies: Optional[Any] = None
        self.policy_mapping_fn: Optional[Callable] = None
        self.policies_to_train: Optional[List[str]] = None

    # fluent sections, reference-style
    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable] = None):
        self.env = env
        self.env_creator = env_creator
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector: Optional[Callable] = None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        return self

    def rl_module(self, *, use_conv: Optional[bool] = None,
                  hidden=None):
        if use_conv is not None:
            self.use_conv = use_conv
        if hidden is not None:
            self.hidden = tuple(hidden)
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 device=None):
        """``num_learners`` rank learners (0: one local learner) and the
        learners' device (None: the card, which must be visible)."""
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def multi_agent(self, *, policies=None,
                    policy_mapping_fn: Optional[Callable] = None,
                    policies_to_train=None):
        """Declare module ids and the agent→module mapping (reference
        ``algorithm_config.py`` ``multi_agent()``). ``policies`` is a
        dict ``module_id → RLModuleSpec | None`` (None ⇒ infer the spec
        from the spaces of an agent that maps to it) or an iterable of
        module ids. ``policy_mapping_fn(agent_id, env_index)`` returns
        the module id acting for that agent; default maps each agent id
        to a module of the same name."""
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def make_env_creator(self) -> Callable:
        if self.env_creator is not None:
            return self.env_creator
        env_name = self.env

        def create():
            import gymnasium

            return gymnasium.make(env_name)

        return create

    def module_spec(self) -> RLModuleSpec:
        env = self.make_env_creator()()
        obs_shape = tuple(env.observation_space.shape)
        if self.env_to_module_connector is not None:
            # The module sees post-connector observations.
            obs_shape = self.env_to_module_connector().out_shape(obs_shape)
        space = env.action_space
        if hasattr(space, "n"):
            spec = RLModuleSpec(
                obs_dim=int(np.prod(obs_shape)),
                num_actions=int(space.n),
                hidden=self.hidden,
                obs_shape=obs_shape if self.use_conv else (),
                conv=self.use_conv)
        else:  # Box: continuous control (SAC/CQL family)
            spec = RLModuleSpec(
                obs_dim=int(np.prod(obs_shape)),
                num_actions=int(np.prod(space.shape)),
                hidden=self.hidden,
                obs_shape=obs_shape if self.use_conv else (),
                conv=self.use_conv,
                continuous=True,
                action_low=np.asarray(space.low, np.float32),
                action_high=np.asarray(space.high, np.float32))
        env.close() if hasattr(env, "close") else None
        return spec

    def build(self) -> "Algorithm":
        if self.policies:
            # Only configs that override build() (PPO) dispatch to a
            # multi-agent algorithm; anything else would silently train
            # a wrong single-agent setup on a dict-keyed env.
            raise NotImplementedError(
                f"multi_agent() is not supported by "
                f"{type(self).__name__}; multi-agent training is "
                f"available for PPO (PPOConfig.multi_agent(...))")
        return self.algo_class(self)  # type: ignore[attr-defined]


class Algorithm:
    """sample → learn → sync loop (reference ``algorithm.py:166``)."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.module_spec = self._make_module_spec(config)
        self.env_runner_group = self._build_env_runner_group()
        try:
            self.learner_group = self._build_learner_group()
        except BaseException:
            self.env_runner_group.stop()    # its runner threads
            raise
        self.iteration = 0
        self._timesteps = 0
        # initial weight sync so rollouts start from learner weights
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def _make_module_spec(self, config: AlgorithmConfig) -> RLModuleSpec:
        """Overridable: algorithms may swap the module class (e.g. DQN's
        epsilon-greedy module) before runners build it."""
        return config.module_spec()

    def _build_env_runner_group(self):
        """Overridable: multi-agent algorithms swap in a runner group
        that speaks the dict-keyed env API."""
        config = self.config
        return EnvRunnerGroup(
            config.make_env_creator(), self.module_spec,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed,
            connector_factory=config.env_to_module_connector)

    def _build_learner_group(self) -> LearnerGroup:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        metrics = self.training_step()
        self.iteration += 1
        metrics.update(self.env_runner_group.get_metrics())
        metrics["training_iteration"] = self.iteration
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        metrics["time_this_iter_s"] = time.time() - t0
        return metrics

    # ------------------------------------------------- checkpointing
    def save_to_path(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, STATE_FILE), "wb") as f:
            pickle.dump({"learner": self.learner_group.get_state(),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps}, f)
        return path

    def restore_from_path(self, path: str):
        with open(os.path.join(path, STATE_FILE), "rb") as f:
            st = pickle.load(f)
        self.learner_group.set_state(st["learner"])
        self.iteration = st["iteration"]
        self._timesteps = st["timesteps"]
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()
