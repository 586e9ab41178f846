"""Multi-agent RL: dict-keyed envs, per-agent episode streams, a module
container, and multi-agent PPO — the port of
``ray_tpu/rllib/multi_agent.py``.

The acting side is copied and stays numpy on the host:
:class:`MultiAgentEnv`, :func:`spec_from_spaces`, :class:`MultiRLModule`
(modules built in sorted id order, module ``i`` seeded ``seed + i``) and
:class:`MultiAgentEnvRunner`, whose trajectories are per-(env, agent,
module) STREAMS: contiguous transition runs that GAE scans per stream,
with delayed rewards accruing to an agent's open transition and each
successor value filled in when the agent next acts. A
:class:`MultiAgentEnvRunnerGroup` runs one local runner or N on runner
threads (:mod:`._threads`), seeded as the reference's remote ones.

Each module learns on a learner group of its own
(:class:`MultiLearnerGroup`: one port ``LearnerGroup`` a module, on the
card unless ``.learners(device=...)`` says otherwise, on ``RankPool``
ranks when ``num_learners > 0``), so modules of different architectures
never share a ragged batch. :class:`MultiAgentPPO` takes per-stream GAE,
then each trainable module's update, then the weight broadcast.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .algorithm import Algorithm
from .env_runner import EnvRunnerGroup, SampleBatch
from .learner import LearnerGroup, PPOLearner, compute_gae
from .rl_module import RLModuleSpec

# ---------------------------------------------------------------- env API


class MultiAgentEnv:
    """Base class for dict-keyed multi-agent environments.

    Contract (reference ``multi_agent_env.py``):
      - ``reset(seed) -> (obs_dict, info_dict)`` — obs for every agent
        that must act first.
      - ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
        infos)`` — all dicts keyed by agent id. Only agents present in
        ``obs`` act next step (turn-based envs return a subset).
        Rewards may name agents that did NOT act this step (delayed
        credit); they accrue to that agent's open transition.
        ``terminateds["__all__"]`` is REQUIRED and ends the episode for
        everyone; per-agent keys retire individual agents early.
    """

    possible_agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


def spec_from_spaces(obs_space, act_space,
                     hidden: Tuple[int, ...] = (64, 64)) -> RLModuleSpec:
    """Build an RLModuleSpec from gymnasium-style spaces (the per-agent
    half of ``AlgorithmConfig.module_spec``)."""
    obs_dim = int(np.prod(obs_space.shape))
    if hasattr(act_space, "n"):
        return RLModuleSpec(obs_dim=obs_dim, num_actions=int(act_space.n),
                            hidden=hidden)
    return RLModuleSpec(
        obs_dim=obs_dim, num_actions=int(np.prod(act_space.shape)),
        hidden=hidden, continuous=True,
        action_low=np.asarray(act_space.low, np.float32),
        action_high=np.asarray(act_space.high, np.float32))


# ------------------------------------------------------------- container


class MultiRLModule:
    """Dict of ``module_id → RLModule`` (reference
    ``multi_rl_module.py``): one acting-side container whose weights
    move as a dict pytree."""

    def __init__(self, specs: Dict[str, RLModuleSpec], seed: int = 0):
        self.specs = specs
        self.modules = {mid: spec.build(seed + i)
                        for i, (mid, spec) in enumerate(sorted(
                            specs.items()))}

    def __getitem__(self, mid: str):
        return self.modules[mid]

    def keys(self):
        return self.modules.keys()

    def get_weights(self) -> Dict[str, Any]:
        return {mid: m.get_weights() for mid, m in self.modules.items()}

    def set_weights(self, weights: Dict[str, Any]):
        for mid, w in weights.items():
            if mid in self.modules:
                self.modules[mid].set_weights(w)


# ------------------------------------------------------------ env runner


class _Pending:
    """An OPEN transition: the agent acted, its next obs hasn't arrived."""

    __slots__ = ("obs", "action", "logp", "value", "reward")

    def __init__(self, obs, action, logp, value):
        self.obs = obs
        self.action = action
        self.logp = logp
        self.value = value
        self.reward = 0.0


class MultiAgentEnvRunner:
    """Steps ``num_envs`` copies of a MultiAgentEnv, accumulating
    per-(env, agent, module) transition streams.

    Stream semantics: a stream is a CONTIGUOUS run of one agent's
    transitions under one module in one env copy, spanning episodes
    (episode boundaries are flagged done/truncated inside the stream —
    ``compute_gae`` cuts there). ``sample()`` drains all closed
    transitions; transitions still waiting for their next observation
    stay open across fragments so every emitted row has a true
    successor state.
    """

    def __init__(self, env_creator: Callable,
                 module_specs: Dict[str, RLModuleSpec],
                 policy_mapping_fn: Optional[Callable] = None,
                 num_envs: int = 1, rollout_fragment_length: int = 200,
                 seed: int = 0):
        self.envs = [env_creator() for _ in range(num_envs)]
        self.marl_module = MultiRLModule(module_specs, seed)
        self.mapping = policy_mapping_fn or (lambda aid, env_idx: str(aid))
        self.T = rollout_fragment_length
        self.rng = np.random.default_rng(seed)
        self._ready: List[Dict[str, np.ndarray]] = [dict() for _ in self.envs]
        self._map: List[Dict[str, str]] = [dict() for _ in self.envs]
        self._pending: Dict[Tuple[int, str], _Pending] = {}
        # (env, agent, module) -> list of closed transition dicts
        self._streams: Dict[Tuple[int, str, str], List[dict]] = {}
        # (env, agent, module) -> index of a closed transition whose
        # next_value is the value we compute when the agent next acts
        self._needs_next: Dict[Tuple[int, str, str], int] = {}
        self.episode_returns = [0.0] * num_envs
        self.completed_returns: List[float] = []
        self._module_ep_returns: Dict[str, List[float]] = {
            mid: [] for mid in module_specs}
        self._module_running: List[Dict[str, float]] = [
            {mid: 0.0 for mid in module_specs} for _ in self.envs]
        for i, env in enumerate(self.envs):
            obs, _ = env.reset(seed=seed + i)
            self._begin_episode(i, obs)

    # ------------------------------------------------------- episode mgmt
    def _begin_episode(self, i: int, obs_dict):
        self._ready[i] = {a: np.asarray(o, np.float32)
                          for a, o in obs_dict.items()}
        self._map[i] = {}
        for mid in self._module_running[i]:
            self._module_running[i][mid] = 0.0

    def _module_of(self, i: int, agent: str) -> str:
        m = self._map[i]
        if agent not in m:
            m[agent] = self.mapping(agent, i)
        return m[agent]

    def _close(self, i: int, agent: str, *, done: bool, trunc: bool,
               next_value: Optional[float]):
        """Move the open transition to its stream. ``next_value=None``
        defers the successor value to the agent's next action (or the
        fragment drain)."""
        p = self._pending.pop((i, agent), None)
        if p is None:
            return
        mid = self._module_of(i, agent)
        key = (i, agent, mid)
        stream = self._streams.setdefault(key, [])
        stream.append({
            "obs": p.obs, "action": p.action, "reward": p.reward,
            "done": done, "trunc": trunc, "logp": p.logp,
            "value": p.value,
            "next_value": 0.0 if done else next_value,
        })
        if not done and next_value is None:
            self._needs_next[key] = len(stream) - 1

    def _finish_episode_tail(self, i: int, term: dict, trunc: dict,
                             final_obs: dict):
        """``__all__`` fired: close every open transition of env ``i``
        and truncate dangling next-value waits (the episode is over —
        nothing after it may leak into GAE)."""
        all_term = bool(term.get("__all__", False))
        for (ei, agent) in [k for k in self._pending if k[0] == i]:
            a_term = bool(term.get(agent, all_term))
            # The episode IS over for everyone: any non-terminated agent
            # is truncated at this point regardless of what its
            # per-agent flag says — an un-cut final transition would
            # let GAE leak into the NEXT episode sharing this stream.
            a_trunc = not a_term
            nv = None
            if not a_term:
                # bootstrap the truncated tail with V(arrival obs);
                # fall back to the action obs if the env omitted it
                mid = self._module_of(i, agent)
                arrival = final_obs.get(agent)
                obs = (np.asarray(arrival, np.float32)
                       if arrival is not None
                       else self._pending[(ei, agent)].obs)
                nv = float(self.marl_module[mid].forward_values(
                    obs[None])[0])
            self._close(i, agent, done=a_term, trunc=a_trunc,
                        next_value=nv)
        # No _needs_next entry for env ``i`` can exist here: entries
        # are created only when a new obs arrives (which also makes the
        # agent ready), every ready agent acts on the next _act() call
        # (popping its entry), and the ``__all__`` branch runs before
        # this step's obs loop could create new ones.
        self.completed_returns.append(self.episode_returns[i])
        self.episode_returns[i] = 0.0
        for mid, ret in self._module_running[i].items():
            self._module_ep_returns[mid].append(ret)

    # ------------------------------------------------------------ stepping
    def _act(self):
        """One policy pass for every ready agent across all envs,
        grouped per module so each module sees one stacked batch."""
        groups: Dict[str, List[Tuple[int, str, np.ndarray]]] = {}
        for i in range(len(self.envs)):
            for agent, obs in self._ready[i].items():
                groups.setdefault(self._module_of(i, agent), []).append(
                    (i, agent, obs))
        actions: List[Dict[str, Any]] = [dict() for _ in self.envs]
        for mid, rows in groups.items():
            obs_batch = np.stack([r[2] for r in rows])
            acts, logp, values = self.marl_module[mid].forward_exploration(
                obs_batch, self.rng)
            for j, (i, agent, obs) in enumerate(rows):
                key = (i, agent, mid)
                if key in self._needs_next:
                    # V(s') for the previous closed transition is the
                    # value just computed at this (its successor) obs
                    self._streams[key][self._needs_next.pop(key)][
                        "next_value"] = float(values[j])
                self._pending[(i, agent)] = _Pending(
                    obs, acts[j], float(logp[j]), float(values[j]))
                actions[i][agent] = acts[j]
        for i in range(len(self.envs)):
            self._ready[i] = {}  # acting consumes the obs
        return actions

    def _step_envs(self, actions: List[Dict[str, Any]]):
        for i, env in enumerate(self.envs):
            # Step even with an empty action dict: an env may have no
            # ready agent this step (idle frames in turn-based games)
            # and only advances — eventually re-emitting obs — when
            # stepped; skipping it would freeze the episode forever.
            acts = {a: (int(v) if np.ndim(v) == 0 else v)
                    for a, v in actions[i].items()}
            obs, rew, term, trunc, _ = env.step(acts)
            for agent, r in rew.items():
                p = self._pending.get((i, agent))
                if p is not None:
                    p.reward += float(r)
                self.episode_returns[i] += float(r)
                mid = self._module_of(i, agent)
                self._module_running[i][mid] += float(r)
            if term.get("__all__", False) or trunc.get("__all__", False):
                self._finish_episode_tail(i, term, trunc, obs)
                new_obs, _ = env.reset()
                self._begin_episode(i, new_obs)
                continue
            # individual exits (agent died, env continues for the rest)
            for agent in set(list(term) + list(trunc)) - {"__all__"}:
                if term.get(agent, False) or trunc.get(agent, False):
                    p = self._pending.get((i, agent))
                    if p is None:
                        continue  # already retired (envs may re-report
                        # flags for dead agents); nothing to close
                    a_term = bool(term.get(agent, False))
                    nv = None
                    if not a_term:
                        mid = self._module_of(i, agent)
                        arrival = obs.get(agent)
                        src = (np.asarray(arrival, np.float32)
                               if arrival is not None else p.obs)
                        nv = float(self.marl_module[mid].forward_values(
                            src[None])[0])
                    self._close(i, agent, done=a_term,
                                trunc=not a_term, next_value=nv)
            for agent, o in obs.items():
                a_term = bool(term.get(agent, False))
                a_trunc = bool(trunc.get(agent, False))
                if a_term or a_trunc:
                    continue  # closed above; agent is out
                # new obs arrived: close the open transition (its
                # successor value comes at the agent's next action)
                self._close(i, agent, done=False, trunc=False,
                            next_value=None)
                self._ready[i][agent] = np.asarray(o, np.float32)

    # -------------------------------------------------------------- drain
    def sample(self) -> Dict[str, SampleBatch]:
        for _ in range(self.T):
            self._step_envs(self._act())
        # fill dangling next-values with a bootstrap at the held obs
        fill: Dict[str, List[Tuple[Tuple, int, np.ndarray]]] = {}
        for key, idx in self._needs_next.items():
            i, agent, mid = key
            held = self._ready[i].get(agent)
            obs = held if held is not None else self._streams[key][idx]["obs"]
            fill.setdefault(mid, []).append((key, idx, obs))
        for mid, rows in fill.items():
            vals = self.marl_module[mid].forward_values(
                np.stack([r[2] for r in rows]))
            for (key, idx, _), v in zip(rows, vals):
                self._streams[key][idx]["next_value"] = float(v)
        self._needs_next.clear()

        out: Dict[str, SampleBatch] = {}
        per_mod: Dict[str, List[List[dict]]] = {}
        for key in sorted(self._streams):
            stream = self._streams[key]
            if stream:
                per_mod.setdefault(key[2], []).append(stream)
        self._streams = {}
        for mid, streams in per_mod.items():
            cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                    "truncateds", "logp", "values",
                                    "next_values")}
            lens = []
            for stream in streams:
                lens.append(len(stream))
                for tr in stream:
                    cols["obs"].append(tr["obs"])
                    cols["actions"].append(tr["action"])
                    cols["rewards"].append(tr["reward"])
                    cols["dones"].append(tr["done"])
                    cols["truncateds"].append(tr["trunc"])
                    cols["logp"].append(tr["logp"])
                    cols["values"].append(tr["value"])
                    cols["next_values"].append(tr["next_value"])
            out[mid] = SampleBatch(
                obs=np.stack(cols["obs"]).astype(np.float32),
                actions=np.asarray(cols["actions"]),
                rewards=np.asarray(cols["rewards"], np.float32),
                dones=np.asarray(cols["dones"], bool),
                truncateds=np.asarray(cols["truncateds"], bool),
                logp=np.asarray(cols["logp"], np.float32),
                values=np.asarray(cols["values"], np.float32),
                next_values=np.asarray(cols["next_values"], np.float32),
                _streams=np.asarray(lens, np.int64),
            )
        return out

    # ------------------------------------------------------------ weights
    def set_weights(self, weights: Dict[str, Any]):
        self.marl_module.set_weights(weights)

    def get_metrics(self) -> Dict[str, Any]:
        recent = self.completed_returns[-100:]
        out = {
            "num_episodes": len(self.completed_returns),
            "episode_return_mean": float(np.mean(recent)) if recent else 0.0,
            "episode_return_max": float(np.max(recent)) if recent else 0.0,
        }
        for mid, rets in self._module_ep_returns.items():
            r = rets[-100:]
            out[f"module/{mid}/episode_return_mean"] = (
                float(np.mean(r)) if r else 0.0)
        return out


class MultiAgentEnvRunnerGroup(EnvRunnerGroup):
    """One local multi-agent runner, or ``num_env_runners`` on runner
    threads seeded ``seed + 1000 * (i + 1)`` (mirrors EnvRunnerGroup);
    ``sample()`` gives each runner's ``{module_id: SampleBatch}``."""

    def __init__(self, env_creator, module_specs: Dict[str, RLModuleSpec],
                 policy_mapping_fn=None, num_env_runners: int = 0,
                 num_envs_per_runner: int = 1,
                 rollout_fragment_length: int = 200, seed: int = 0):
        self._start(MultiAgentEnvRunner, num_env_runners, seed,
                    lambda s: (env_creator, module_specs, policy_mapping_fn,
                               num_envs_per_runner, rollout_fragment_length,
                               s))

    @staticmethod
    def _aggregate(ms: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = EnvRunnerGroup._aggregate(ms)
        for k in ms[0]:
            if k.startswith("module/"):
                vs = [m[k] for m in ms if m["num_episodes"] > 0]
                out[k] = float(np.mean(vs)) if vs else 0.0
        return out


# -------------------------------------------------------------- learners


class MultiLearnerGroup:
    """Per-module LearnerGroups under one state surface, so the base
    Algorithm's checkpoint path works unchanged (reference
    ``learner_group.py`` holding a MultiRLModule; here each module keeps
    its own learner group — no ragged multi-module batches)."""

    def __init__(self, groups: Dict[str, LearnerGroup],
                 policies_to_train: Optional[List[str]] = None):
        self.groups = groups
        self.policies_to_train = (list(policies_to_train)
                                  if policies_to_train is not None
                                  else sorted(groups))

    def update_module(self, mid: str, batch, **kw) -> Dict[str, float]:
        return self.groups[mid].update(batch, **kw)

    def get_weights(self) -> Dict[str, Any]:
        return {mid: g.get_weights() for mid, g in self.groups.items()}

    def get_state(self) -> Dict[str, Any]:
        return {mid: g.get_state() for mid, g in self.groups.items()}

    def set_state(self, state: Dict[str, Any]):
        for mid, st in state.items():
            if mid in self.groups:
                self.groups[mid].set_state(st)

    def stop(self):
        for g in self.groups.values():
            g.stop()


# ------------------------------------------------------------- algorithm


def stream_gae_batch(frags: List[SampleBatch], gamma: float,
                     lam: float) -> Dict[str, np.ndarray]:
    """One module's PPO train batch from its fragments: GAE over each
    contiguous stream segment (``_streams`` lengths)."""
    cols = {k: [] for k in ("obs", "actions", "logp_old",
                            "advantages", "value_targets")}
    for frag in frags:
        lo = 0
        for ln in frag["_streams"]:
            ln = int(ln)
            sl = slice(lo, lo + ln)
            lo += ln
            adv, vtarg = compute_gae(
                frag["rewards"][sl], frag["values"][sl],
                frag["next_values"][sl], frag["dones"][sl],
                frag["truncateds"][sl], np.array([ln, 1]),
                gamma=gamma, lam=lam)
            cols["obs"].append(frag["obs"][sl])
            cols["actions"].append(frag["actions"][sl])
            cols["logp_old"].append(frag["logp"][sl])
            cols["advantages"].append(adv)
            cols["value_targets"].append(vtarg)
    return {k: np.concatenate(v).astype(
        np.int64 if k == "actions" else np.float32)
        for k, v in cols.items()}


class MultiAgentPPO(Algorithm):
    """PPO over a MultiRLModule: per-module GAE on per-stream segments,
    then each trainable module's clipped-surrogate update on its own
    learner group (reference new-stack multi-agent PPO: ``ppo.py`` +
    ``multi_agent_env_runner.py``). Discrete actions.

    Built from a PPOConfig with ``.multi_agent(...)`` set."""

    def _make_module_spec(self, config) -> Dict[str, RLModuleSpec]:
        policies = config.policies
        mapping = config.policy_mapping_fn or (
            lambda aid, env_idx: str(aid))
        items = (policies.items() if isinstance(policies, dict)
                 else [(pid, None) for pid in policies])
        need_env = any(not isinstance(s, RLModuleSpec) for _, s in items)
        env = config.make_env_creator()() if need_env else None
        specs: Dict[str, RLModuleSpec] = {}
        try:
            for pid, spec in items:
                if not isinstance(spec, RLModuleSpec):
                    agents = [a for a in env.possible_agents
                              if mapping(a, 0) == pid]
                    if not agents:
                        raise ValueError(
                            f"no agent in possible_agents maps to module "
                            f"{pid!r}; pass an explicit RLModuleSpec")
                    a = agents[0]
                    spec = spec_from_spaces(
                        env.observation_spaces[a], env.action_spaces[a],
                        config.hidden)
                if spec.continuous:  # explicit AND inferred specs
                    raise NotImplementedError(
                        f"module {pid!r} has a continuous action space; "
                        f"MultiAgentPPO trains discrete actions only")
                specs[pid] = spec
        finally:
            if env is not None:
                env.close()
        return specs

    def _build_env_runner_group(self):
        config = self.config
        return MultiAgentEnvRunnerGroup(
            config.make_env_creator(), self.module_spec,
            policy_mapping_fn=config.policy_mapping_fn,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            seed=config.seed)

    def _build_learner_group(self) -> MultiLearnerGroup:
        cfg = self.config
        groups: Dict[str, LearnerGroup] = {}
        try:
            for mid, spec in self.module_spec.items():
                factory = functools.partial(
                    PPOLearner, spec, lr=cfg.lr, clip_param=cfg.clip_param,
                    vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
                    grad_clip=cfg.grad_clip, seed=cfg.seed)
                groups[mid] = LearnerGroup(factory,
                                           num_learners=cfg.num_learners,
                                           device=cfg.device)
        except BaseException:
            for g in groups.values():
                g.stop()
            raise
        return MultiLearnerGroup(groups, cfg.policies_to_train)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # 1. sample until train_batch_size TOTAL env steps (summed over
        #    modules — one env step yields one transition per acting
        #    agent, the reference's count_steps_by="env_steps" analog)
        per_module: Dict[str, List[SampleBatch]] = {}
        collected = 0
        while collected < cfg.train_batch_size:
            for batches in self.env_runner_group.sample():
                for mid, b in batches.items():
                    per_module.setdefault(mid, []).append(b)
                    collected += len(b)
        self._timesteps += collected

        # 2. per-module GAE over each contiguous stream segment
        metrics: Dict[str, Any] = {}
        for mid in self.learner_group.policies_to_train:
            frags = per_module.get(mid)
            if not frags:
                continue
            m = self.learner_group.update_module(
                mid, stream_gae_batch(frags, cfg.gamma, cfg.lam),
                minibatch_size=cfg.minibatch_size,
                num_epochs=cfg.num_epochs, shuffle_seed=self.iteration)
            for k, v in m.items():
                metrics[f"module/{mid}/{k}"] = v

        # 3. broadcast fresh weights
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        metrics["num_env_steps_trained"] = collected
        return metrics
