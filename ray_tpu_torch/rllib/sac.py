"""SAC: off-policy actor-critic for continuous actions — the port of
``ray_tpu/rllib/sac.py``.

Twin Q networks, a squashed-Gaussian policy, entropy temperature
auto-tuning and polyak-averaged targets, in one step that updates
critics, actor and temperature together on the learner's device. The
step's noise follows the reference's key chain draw for draw with the
port's threefry (bit-equal to ``jax.random``): each update splits the
learner's key into (next key, k); k splits into k1, k2, k3; k1 draws the
next action's normals, k3 CQL's uniform actions, ``split(k2, cql_n)``
CQL's policy actions, and k2 again the actor's action (the reference
reuses it). The numpy rollout module and the parameter init are copied.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._private import prng, tree
from .._private.device import DeviceLike, full_f32, resolve_device
from ._optim import Adam, value_and_grad
from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup
from .replay_buffer import ReplayBuffer
from .rl_module import Params, RLModuleSpec, dense_init as _init_dense
from .rl_module import params_to_numpy, params_to_torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_sac_params(spec: RLModuleSpec, seed: int) -> Params:
    rng = np.random.default_rng(seed)
    act_dim = spec.num_actions
    sizes = (spec.obs_dim,) + spec.hidden
    q_sizes = (spec.obs_dim + act_dim,) + spec.hidden

    def mlp(ins):
        return [_init_dense(rng, ins[i], ins[i + 1])
                for i in range(len(ins) - 1)]

    return {
        "actor": {"hidden": mlp(sizes),
                  "mean": _init_dense(rng, sizes[-1], act_dim, scale=0.01),
                  "log_std": _init_dense(rng, sizes[-1], act_dim,
                                         scale=0.01)},
        "q1": {"hidden": mlp(q_sizes),
               "out": _init_dense(rng, q_sizes[-1], 1, scale=1.0)},
        "q2": {"hidden": mlp(q_sizes),
               "out": _init_dense(rng, q_sizes[-1], 1, scale=1.0)},
    }


def actor_forward(params: Params, obs, xp=np) -> Tuple[Any, Any]:
    """(mean, log_std) of the pre-squash Gaussian; ``xp`` is numpy or
    torch."""
    h = obs
    for layer in params["actor"]["hidden"]:
        h = xp.tanh(h @ layer["w"] + layer["b"])
    mean = h @ params["actor"]["mean"]["w"] + params["actor"]["mean"]["b"]
    log_std = h @ params["actor"]["log_std"]["w"] + \
        params["actor"]["log_std"]["b"]
    log_std = xp.clip(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return mean, log_std


def q_forward(q_params: Params, obs, actions, xp=np):
    h = xp.concatenate([obs, actions], axis=-1)
    for layer in q_params["hidden"]:
        h = xp.tanh(h @ layer["w"] + layer["b"])
    return (h @ q_params["out"]["w"] + q_params["out"]["b"])[..., 0]


def squash_logp(u, log_std, mean, xp=np):
    """log π of a tanh-squashed Gaussian sample ``a = tanh(u)``; the
    stable tanh-Jacobian form ``2(log2 - u - softplus(-2u))``, softplus
    being ``logaddexp(x, 0)`` on both paths (``jax.nn.softplus``;
    ``F.softplus`` switches to ``x`` past a threshold and is another
    function)."""
    var = xp.exp(2 * log_std)
    gauss = -0.5 * (((u - mean) ** 2) / var + 2 * log_std
                    + np.log(2 * np.pi))
    if xp is np:
        softplus = np.logaddexp(0.0, -2 * u)
    else:
        x = -2 * u
        softplus = torch.logaddexp(x, torch.zeros_like(x))
    # log|da/du| = log(1 - tanh²u) = 2(log2 - u - softplus(-2u));
    # change of variables SUBTRACTS the Jacobian term.
    corr = 2.0 * (np.log(2.0) - u - softplus)
    return (gauss - corr).sum(-1)


class SquashedGaussianModule:
    """Continuous-action module: numpy rollout path for env runners (the
    card belongs to the learner), torch math in :class:`SACLearner`."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0):
        self.spec = spec
        self.params: Params = init_sac_params(spec, seed)
        low = np.asarray(spec.action_low, np.float32)
        high = np.asarray(spec.action_high, np.float32)
        self.scale = (high - low) / 2.0
        self.center = (high + low) / 2.0

    def _to_env(self, a):
        return a * self.scale + self.center

    def forward_exploration(self, obs: np.ndarray,
                            rng: np.random.Generator):
        mean, log_std = actor_forward(self.params, obs, np)
        u = mean + np.exp(log_std) * rng.standard_normal(mean.shape)
        a = np.tanh(u)
        logp = squash_logp(u, log_std, mean, np)
        values = np.zeros(len(a), np.float32)  # SAC has no V-head
        return self._to_env(a).astype(np.float32), \
            logp.astype(np.float32), values

    def forward_inference(self, obs: np.ndarray):
        mean, _ = actor_forward(self.params, obs, np)
        return self._to_env(np.tanh(mean)).astype(np.float32)

    def forward_values(self, obs: np.ndarray) -> np.ndarray:
        return np.zeros(len(obs), np.float32)

    def get_weights(self) -> Params:
        return self.params

    def set_weights(self, params: Params):
        self.params = params


class SACLearner:
    """One step: critic TD on min-target-Q with entropy bonus,
    reparameterized actor loss, temperature auto-tuning (and, with
    ``cql_weight > 0``, CQL's conservative regularizer)."""

    def __init__(self, module_spec: RLModuleSpec, *, lr: float = 3e-4,
                 gamma: float = 0.99, tau: float = 0.005,
                 grad_clip: float = 40.0, target_entropy: float = None,
                 init_alpha: float = 1.0, seed: int = 0,
                 cql_weight: float = 0.0, cql_num_actions: int = 10,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = module_spec
        self.gamma = gamma
        self.tau = tau
        self.cql_weight = cql_weight
        self.cql_num_actions = cql_num_actions
        self.target_entropy = (
            -float(module_spec.num_actions)
            if target_entropy is None else float(target_entropy))
        self.optimizer = Adam(lr, grad_clip=grad_clip)
        params = module_spec.build(seed).params
        params["log_alpha"] = np.asarray(np.log(init_alpha), np.float32)
        self.params = params_to_torch(params, self.device)
        self.target_q = params_to_torch(
            {"q1": params["q1"], "q2": params["q2"]}, self.device)
        self.opt_state = self.optimizer.init(self.params)
        self._rng_key = torch.from_numpy(
            prng.PRNGKey(seed).astype(np.int64)).to(self.device)
        low = np.asarray(module_spec.action_low, np.float32)
        high = np.asarray(module_spec.action_high, np.float32)
        self._scale = torch.from_numpy((high - low) / 2.0).to(self.device)
        self._center = torch.from_numpy((high + low) / 2.0).to(self.device)

    def draws(self, key: torch.Tensor, batch_size: int
              ) -> Dict[str, torch.Tensor]:
        """The noise of one step from its key: ``next`` (k1) and ``pi``
        (k2) standard normals ``[B, A]``; with CQL, ``cql_rand`` (k3)
        uniforms in [-1, 1) and ``cql_pi`` (``split(k2, cql_n)``) normals,
        both ``[cql_n, B, A]``."""
        k1, k2, k3 = prng.split(key, 3)
        shape = (batch_size, self.spec.num_actions)
        out = {"next": prng.normal(k1, shape), "pi": prng.normal(k2, shape)}
        if self.cql_weight > 0.0:
            n = self.cql_num_actions
            out["cql_rand"] = prng.uniform(k3, (n,) + shape, -1.0, 1.0)
            out["cql_pi"] = prng.normal(prng.split(k2, n), shape)
        return out

    def _sample_action(self, params, obs, noise):
        mean, log_std = actor_forward(params, obs, torch)
        u = mean + torch.exp(log_std) * noise
        a = torch.tanh(u)
        return a * self._scale + self._center, \
            squash_logp(u, log_std, mean, torch)

    def _loss(self, params, target_q, batch, noise):
        scale, center = self._scale, self._center
        obs = batch["obs"]
        alpha = torch.exp(params["log_alpha"])
        # --- critic: its target carries no gradient ---
        with torch.no_grad():
            a_next, logp_next = self._sample_action(
                params, batch["next_obs"], noise["next"])
            qt = torch.minimum(
                q_forward(target_q["q1"], batch["next_obs"], a_next, torch),
                q_forward(target_q["q2"], batch["next_obs"], a_next, torch))
            target = batch["rewards"] + self.gamma * (
                1 - batch["dones"]) * (qt - alpha * logp_next)
        q1 = q_forward(params["q1"], obs, batch["actions"], torch)
        q2 = q_forward(params["q2"], obs, batch["actions"], torch)
        critic_loss = torch.mean((q1 - target) ** 2) + \
            torch.mean((q2 - target) ** 2)
        # --- CQL regularizer: logsumexp over random + policy actions
        # pushes down out-of-distribution Q (the policy actions keep
        # their gradient, as in the reference) ---
        cql_loss = 0.0
        if self.cql_weight > 0.0:
            n = self.cql_num_actions
            rand_a = noise["cql_rand"] * scale + center
            pol_a, pol_logp = self._sample_action(params, obs,
                                                  noise["cql_pi"])
            # importance weights: uniform density over the env action box
            # for random actions, (scale-corrected) policy density for
            # policy actions
            log_u = -torch.sum(torch.log(2.0 * scale))
            pol_logp_env = pol_logp - torch.sum(torch.log(scale))
            obs_n = obs.expand((n,) + obs.shape)

            def cat_q(qp):
                q_rand = q_forward(qp, obs_n, rand_a, torch)
                q_pol = q_forward(qp, obs_n, pol_a, torch)
                return torch.cat([q_rand - log_u, q_pol - pol_logp_env], 0)

            log_2n = math.log(2.0 * n)
            lse1 = torch.logsumexp(cat_q(params["q1"]), 0) - log_2n
            lse2 = torch.logsumexp(cat_q(params["q2"]), 0) - log_2n
            cql_loss = self.cql_weight * (torch.mean(lse1 - q1)
                                          + torch.mean(lse2 - q2))
        # --- actor ---
        a_pi, logp_pi = self._sample_action(params, obs, noise["pi"])
        q_pi = torch.minimum(q_forward(params["q1"], obs, a_pi, torch),
                             q_forward(params["q2"], obs, a_pi, torch))
        actor_loss = torch.mean(alpha.detach() * logp_pi - q_pi)
        # --- temperature ---
        alpha_loss = -torch.mean(params["log_alpha"] * (
            logp_pi + self.target_entropy).detach())
        loss = critic_loss + actor_loss + alpha_loss + cql_loss
        return loss, {"critic_loss": critic_loss,
                      "actor_loss": actor_loss,
                      "alpha_loss": alpha_loss,
                      "cql_loss": cql_loss,
                      "alpha": alpha,
                      "q_mean": q1.mean(),
                      "entropy": -logp_pi.mean()}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        self._rng_key, key = prng.split(self._rng_key)
        feed = params_to_torch({
            "obs": batch["obs"].astype(np.float32),
            "actions": batch["actions"].astype(np.float32),
            "rewards": batch["rewards"].astype(np.float32),
            "next_obs": batch["next_obs"].astype(np.float32),
            "dones": batch["dones"].astype(np.float32),
        }, self.device)
        tau = self.tau
        with full_f32():
            noise = self.draws(key, len(batch["obs"]))
            (_, aux), grads = value_and_grad(self._loss, self.params,
                                             self.target_q, feed, noise)
            self.params, self.opt_state = self.optimizer.update(
                self.params, grads, self.opt_state)
            with torch.no_grad():
                self.target_q = tree.map_with_path(
                    lambda _, t, o: (1 - tau) * t + tau * o, self.target_q,
                    {"q1": self.params["q1"], "q2": self.params["q2"]})
        return {k: float(v) for k, v in aux.items()}

    # -- weight/state plumbing (same shape as the other learners) ------
    def get_weights(self):
        w = params_to_numpy(self.params)
        w.pop("log_alpha", None)
        return w

    def set_weights(self, weights):
        la = self.params.get("log_alpha")
        self.params = params_to_torch(dict(weights), self.device)
        if "log_alpha" not in self.params and la is not None:
            self.params["log_alpha"] = la

    def get_state(self):
        return {"params": params_to_numpy(self.params),
                "target_q": params_to_numpy(self.target_q),
                "opt_state": params_to_numpy(self.opt_state)}

    def set_state(self, state):
        self.params = params_to_torch(state["params"], self.device)
        self.target_q = params_to_torch(state["target_q"], self.device)
        self.opt_state = params_to_torch(state["opt_state"], self.device)

    def update_full(self, batch, **kw):
        return self.update(batch)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = SAC
        self.lr = 3e-4
        self.tau = 0.005
        self.train_batch_size = 256
        self.replay_capacity = 100_000
        self.num_steps_sampled_before_learning = 1500
        # ~1 gradient update per sampled env step (the canonical SAC
        # ratio; matches 4 envs × 64-step fragments)
        self.updates_per_iteration = 256
        self.rollout_fragment_length = 64
        self.target_entropy = None      # default: -action_dim
        self.init_alpha = 1.0
        self.grad_clip = 40.0


class SAC(Algorithm):
    def __init__(self, config: SACConfig):
        self._replay = None
        super().__init__(config)

    def _make_module_spec(self, config):
        spec = config.module_spec()
        if not spec.continuous:
            raise ValueError("SAC requires a continuous (Box) action space")
        spec.module_cls = SquashedGaussianModule
        return spec

    def _build_learner_group(self):
        cfg = self.config
        self._replay = ReplayBuffer(cfg.replay_capacity, seed=cfg.seed)
        group = LearnerGroup(functools.partial(
            SACLearner, self.module_spec, lr=cfg.lr, gamma=cfg.gamma,
            tau=cfg.tau, grad_clip=cfg.grad_clip,
            target_entropy=cfg.target_entropy, init_alpha=cfg.init_alpha,
            seed=cfg.seed), device=cfg.device)
        self._learner = group.local
        self._updates = 0
        return group

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for batch in self.env_runner_group.sample():
            self._timesteps += len(batch)
            self._replay.add({
                "obs": batch["obs"], "actions": batch["actions"],
                "rewards": batch["rewards"],
                "next_obs": batch["next_obs"],
                "dones": batch["dones"].astype(np.float32),
            })
        metrics: Dict[str, Any] = {}
        if len(self._replay) >= cfg.num_steps_sampled_before_learning:
            for _ in range(cfg.updates_per_iteration):
                sample = self._replay.sample(cfg.train_batch_size)
                metrics = self._learner.update(sample)
                self._updates += 1
        self.env_runner_group.sync_weights(self._learner.get_weights())
        metrics["replay_size"] = len(self._replay)
        metrics["num_updates"] = self._updates
        return metrics
