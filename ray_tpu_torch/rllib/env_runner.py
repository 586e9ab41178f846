"""Env runners: vectorized sampling with RLModule inference on the host —
the port of ``ray_tpu/rllib/env_runner.py``.

:class:`SampleBatch` and :class:`SingleAgentEnvRunner` are copied
(numpy; the module's rollout forward, so sampling never touches the
card). Where the reference's group makes remote runner actors
(``env_runner.py:195-203``), this one hosts each runner on a thread of
its own (:mod:`._threads`), with the reference's seeds and call order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ._threads import SAMPLE_TIMEOUT_S, SYNC_TIMEOUT_S, RunnerThread, get
from .rl_module import RLModuleSpec


class SampleBatch:
    """Flat rollout fragment (time-major concat of all vector envs)."""

    KEYS = ("obs", "actions", "rewards", "dones", "truncateds",
            "logp", "values", "next_values")

    def __init__(self, **cols):
        self.cols = cols

    def __getitem__(self, k):
        return self.cols[k]

    def __len__(self):
        return len(self.cols["obs"])

    @staticmethod
    def concat(batches: List["SampleBatch"]) -> "SampleBatch":
        return SampleBatch(**{
            k: np.concatenate([b.cols[k] for b in batches])
            for k in batches[0].cols
        })


class SingleAgentEnvRunner:
    """Steps ``num_envs`` copies of a gymnasium env for T steps per call."""

    def __init__(self, env_creator: Callable, module_spec: RLModuleSpec,
                 num_envs: int = 1, rollout_fragment_length: int = 200,
                 seed: int = 0, connector_factory: Optional[Callable] = None):
        self.envs = [env_creator() for _ in range(num_envs)]
        self.module = module_spec.build(seed)
        self.T = rollout_fragment_length
        self.rng = np.random.default_rng(seed)
        # env→module connector pipeline (obs preprocessing; see
        # connectors.py). Raw env obs pass through it before the module
        # sees them and before they are recorded into sample batches.
        self.connector = connector_factory() if connector_factory else None
        raw = np.stack([e.reset(seed=seed + i)[0]
                        for i, e in enumerate(self.envs)])
        self.obs = self._connect(raw)
        self.episode_returns = [0.0] * num_envs
        self.completed_returns: List[float] = []

    def _connect(self, raw_batch, slots=None):
        if self.connector is None:
            return np.asarray(raw_batch, np.float32)
        return self.connector(raw_batch, slots)

    def set_weights(self, weights):
        self.module.set_weights(weights)

    def sample(self) -> SampleBatch:
        N, T = len(self.envs), self.T
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        continuous = getattr(self.module.spec, "continuous", False)
        if continuous:
            act_buf = np.zeros((T, N, self.module.spec.num_actions),
                               np.float32)
        else:
            act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), bool)
        trunc_buf = np.zeros((T, N), bool)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        # true successor obs at truncation points (see bootstrap below)
        final_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        # (t, slot) -> bootstrap value captured at truncation time with
        # the episode's own recurrent state (stateful modules only)
        recurrent_trunc_vals: dict = {}

        for t in range(T):
            actions, logp, values = self.module.forward_exploration(
                self.obs, self.rng)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            for i, env in enumerate(self.envs):
                o, r, term, trunc, _ = env.step(
                    actions[i] if continuous else int(actions[i]))
                rew_buf[t, i] = r
                done_buf[t, i] = term
                trunc_buf[t, i] = trunc
                self.episode_returns[i] += r
                # true successor state (pre-reset) — off-policy algorithms
                # (DQN replay) need s' even across episode boundaries
                final_buf[t, i] = self._connect(
                    np.asarray(o, np.float32)[None], slots=[i])[0]
                if term or trunc:
                    self.completed_returns.append(self.episode_returns[i])
                    self.episode_returns[i] = 0.0
                    if trunc and not term and \
                            getattr(self.module, "recurrent", False):
                        # The truncated state's bootstrap value must use
                        # THIS episode's recurrent state — capture it
                        # now, before the slot state is reset (and later
                        # overwritten by the next episode).
                        recurrent_trunc_vals[(t, i)] = float(
                            self.module.forward_values(
                                final_buf[t, i][None], slots=[i])[0])
                    if self.connector is not None:
                        self.connector.reset(i)
                    # Recurrent modules (DreamerV3's RSSM) carry
                    # per-slot state across steps; a new episode must
                    # start from the zero state.
                    if hasattr(self.module, "on_episode_reset"):
                        self.module.on_episode_reset(i)
                    o = env.reset()[0]
                    o = self._connect(
                        np.asarray(o, np.float32)[None], slots=[i])[0]
                    self.obs[i] = o
                else:
                    self.obs[i] = final_buf[t, i]

        # bootstrap values for the step AFTER each transition
        next_vals_last = self.module.forward_values(self.obs)
        next_val_buf = np.zeros((T, N), np.float32)
        next_val_buf[:-1] = val_buf[1:]
        next_val_buf[-1] = next_vals_last
        # truncated (not terminated) transitions bootstrap V of the TRUE
        # successor, not of the reset obs that follows in the buffer
        trunc_only = trunc_buf & ~done_buf
        if trunc_only.any():
            if getattr(self.module, "recurrent", False):
                # Values were captured at truncation time, before the
                # slot's recurrent state was reset (computing them here
                # would read the NEXT episode's state).
                for (t, i), v in recurrent_trunc_vals.items():
                    next_val_buf[t, i] = v
            else:
                next_val_buf[trunc_only] = self.module.forward_values(
                    final_buf[trunc_only])
        # terminated states bootstrap 0
        next_val_buf[done_buf] = 0.0

        def flat(x):
            return x.reshape((T * N,) + x.shape[2:])

        return SampleBatch(
            obs=flat(obs_buf), actions=flat(act_buf), rewards=flat(rew_buf),
            dones=flat(done_buf), truncateds=flat(trunc_buf),
            logp=flat(logp_buf), values=flat(val_buf),
            next_values=flat(next_val_buf), next_obs=flat(final_buf),
            # episode boundaries for GAE: time-major layout preserved
            _shape=np.array([T, N]),
        )

    def get_metrics(self) -> Dict[str, Any]:
        recent = self.completed_returns[-100:]
        out = {
            "num_episodes": len(self.completed_returns),
            "episode_return_mean": float(np.mean(recent)) if recent else 0.0,
            "episode_return_max": float(np.max(recent)) if recent else 0.0,
        }
        return out


class EnvRunnerGroup:
    """Env runners (reference ``EnvRunnerGroup.foreach_worker``).

    ``num_env_runners == 0`` → a single local runner (debug mode, like the
    reference's local worker); else ``num_env_runners`` runners, runner
    ``i`` seeded ``seed + 1000 * (i + 1)`` and on a thread of its own."""

    def __init__(self, env_creator, module_spec: RLModuleSpec,
                 num_env_runners: int = 0, num_envs_per_runner: int = 1,
                 rollout_fragment_length: int = 200, seed: int = 0,
                 connector_factory: Optional[Callable] = None):
        self._start(SingleAgentEnvRunner, num_env_runners, seed,
                    lambda s: (env_creator, module_spec,
                               num_envs_per_runner, rollout_fragment_length,
                               s, connector_factory))

    def _start(self, cls, num_env_runners: int, seed: int,
               args: Callable[[int], tuple]):
        """One local ``cls(*args(seed))``, or ``num_env_runners`` on
        runner threads, runner ``i`` built from ``args(seed + 1000 * (i +
        1))``."""
        self.local = None
        self.remote: List[RunnerThread] = []
        if num_env_runners == 0:
            self.local = cls(*args(seed))
            return
        try:
            for i in range(num_env_runners):
                self.remote.append(RunnerThread(
                    cls, *args(seed + 1000 * (i + 1)),
                    name=f"{cls.__name__}-{i}"))
        except BaseException:
            self.stop()
            raise

    def sync_weights(self, weights):
        if self.local:
            self.local.set_weights(weights)
        if self.remote:
            # One host copy shared by every runner: runners only read it.
            get([r.call("set_weights", weights) for r in self.remote],
                timeout=SYNC_TIMEOUT_S)

    def sample(self) -> List[Any]:
        if self.local:
            return [self.local.sample()]
        return get([r.call("sample") for r in self.remote],
                   timeout=SAMPLE_TIMEOUT_S)

    def sample_async_refs(self):
        """Queue sample() on every runner; ``(runner, future)`` pairs
        (the IMPALA path)."""
        return [(r, r.call("sample")) for r in self.remote]

    def get_metrics(self) -> Dict[str, Any]:
        if self.local:
            return self.local.get_metrics()
        return self._aggregate(get([r.call("get_metrics")
                                    for r in self.remote],
                                   timeout=SYNC_TIMEOUT_S))

    @staticmethod
    def _aggregate(ms: List[Dict[str, Any]]) -> Dict[str, Any]:
        total = sum(m["num_episodes"] for m in ms)
        means = [m["episode_return_mean"] for m in ms
                 if m["num_episodes"] > 0]
        return {
            "num_episodes": total,
            "episode_return_mean": float(np.mean(means)) if means else 0.0,
            "episode_return_max": max((m["episode_return_max"]
                                       for m in ms), default=0.0),
        }

    def stop(self):
        for r in self.remote:
            r.stop()
