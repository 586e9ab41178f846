"""IMPALA — the port of ``ray_tpu/rllib/impala.py``: asynchronous
sampling decoupled from learning through in-flight sample requests,
importance-corrected V-trace-style off-policy updates, throttled weight
broadcast (``broadcast_interval``).

The reference's runner and aggregator actors are runner threads here
(:mod:`._threads`): each runner keeps up to ``max_requests_in_flight``
sample calls queued on its thread, the driver harvests whichever are
done (blocking for at least one), and fragment futures go to an
aggregator thread, which waits on them itself, as the reference's
aggregators pull refs. Batches are built in numpy on the host; the
learner is the port's ``PPOLearner`` on its device.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools
from typing import Any, Dict, List

import numpy as np

from ._threads import SYNC_TIMEOUT_S, RunnerThread, get, wait
from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup, PPOLearner, compute_gae
from .rl_module import module_forward

#: Seconds an aggregator may take for a batch (fragments included).
AGGREGATE_TIMEOUT_S = 120.0


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = IMPALA
        self.broadcast_interval = 1     # learner steps between syncs
        self.max_requests_in_flight = 2  # per env runner
        self.vtrace_rho_clip = 1.0
        # >0 → build ρ/GAE batches on aggregator threads
        # (reference: ``impala.py num_aggregation_workers``)
        self.num_aggregation_workers = 0


class _Aggregator:
    """Turns raw fragments into v-trace train batches off the driver's
    thread (reference: IMPALA's aggregation workers).

    Fragments arrive as futures of runner samples (or as batches); the
    current policy weights are refreshed by the driver whenever it
    broadcasts to runners, so ρ is computed against the same snapshot.
    """

    def __init__(self, spec, gamma: float, lam: float, rho_clip: float):
        self.spec = spec
        self.gamma = gamma
        self.lam = lam
        self.rho_clip = rho_clip
        self.weights = None

    def set_weights(self, w):
        self.weights = w
        return True

    def build_batch(self, fragments: List[Any]) -> Dict[str, np.ndarray]:
        fragments = [f.result(timeout=AGGREGATE_TIMEOUT_S)
                     if isinstance(f, cf.Future) else f for f in fragments]
        cols = {k: [] for k in ("obs", "actions", "logp_old",
                                "advantages", "value_targets")}
        for frag in fragments:
            logits, _ = module_forward(self.spec, self.weights,
                                       frag["obs"], np)
            z = logits - logits.max(-1, keepdims=True)
            logp_all = z - np.log(np.exp(z).sum(-1, keepdims=True))
            logp_cur = logp_all[np.arange(len(frag["actions"])),
                                frag["actions"]]
            rho = np.clip(np.exp(logp_cur - frag["logp"]), None,
                          self.rho_clip).astype(np.float32)
            adv, vtarg = compute_gae(
                frag["rewards"], frag["values"], frag["next_values"],
                frag["dones"], frag["truncateds"], frag["_shape"],
                gamma=self.gamma, lam=self.lam, rho=rho)
            cols["obs"].append(frag["obs"])
            cols["actions"].append(frag["actions"])
            cols["logp_old"].append(frag["logp"])
            cols["advantages"].append(adv)
            cols["value_targets"].append(vtarg)
        return {k: np.concatenate(v).astype(
            np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}


class IMPALA(Algorithm):
    """Async: keep every runner busy with queued sample() calls; the
    learner trains on whatever arrives (off-policy by a bounded lag)."""

    def __init__(self, config: "IMPALAConfig"):
        super().__init__(config)
        if not self.env_runner_group.remote:
            self.stop()
            raise ValueError("IMPALA requires num_env_runners >= 1 "
                             "(async sampling needs remote runners)")
        self._inflight: Dict[cf.Future, RunnerThread] = {}
        self._since_broadcast = 0
        self._aggregators: List[RunnerThread] = []
        self._agg_rr = 0
        try:
            for i in range(config.num_aggregation_workers):
                self._aggregators.append(RunnerThread(
                    _Aggregator, self.module_spec, config.gamma,
                    config.lam, config.vtrace_rho_clip,
                    name=f"aggregator-{i}"))
            self._sync_aggregators()
        except BaseException:
            self.stop()
            raise

    def _sync_aggregators(self):
        if self._aggregators:
            w = self.learner_group.get_weights()
            get([a.call("set_weights", w) for a in self._aggregators],
                timeout=SYNC_TIMEOUT_S)

    def _build_learner_group(self) -> LearnerGroup:
        cfg = self.config
        factory = functools.partial(
            PPOLearner, self.module_spec, lr=cfg.lr,
            clip_param=cfg.clip_param, vf_coeff=cfg.vf_coeff,
            entropy_coeff=cfg.entropy_coeff, grad_clip=cfg.grad_clip,
            seed=cfg.seed)
        return LearnerGroup(factory, num_learners=cfg.num_learners,
                            device=cfg.device)

    def _fill_sample_pipeline(self):
        per_runner: Dict[int, int] = {}
        for runner in self._inflight.values():
            per_runner[id(runner)] = per_runner.get(id(runner), 0) + 1
        for runner in self.env_runner_group.remote:
            while per_runner.get(id(runner), 0) < \
                    self.config.max_requests_in_flight:
                self._inflight[runner.call("sample")] = runner
                per_runner[id(runner)] = per_runner.get(id(runner), 0) + 1

    def training_step(self) -> Dict[str, Any]:
        cfg: IMPALAConfig = self.config
        self._fill_sample_pipeline()

        # harvest whatever fragments are ready (block until at least one
        # — a timed-out wait with none ready just retries). With
        # aggregators the fragments go to them as futures.
        ready_refs: List[cf.Future] = []
        while not ready_refs:
            refs = list(self._inflight)
            ready, _ = wait(refs, num_returns=1, timeout=SYNC_TIMEOUT_S)
            # opportunistically grab more that are already done
            more, _ = wait(refs, num_returns=len(refs), timeout=0)
            ready_refs = list(dict.fromkeys(ready + more))
            for ref in ready_refs:
                self._inflight.pop(ref, None)
            self._fill_sample_pipeline()

        # V-trace-style off-policy correction: ρ = π_cur/π_behavior,
        # clipped at vtrace_rho_clip, weights the GAE deltas; behavior
        # logp came from the (stale) sampling weights.
        if self._aggregators:
            agg = self._aggregators[self._agg_rr % len(self._aggregators)]
            self._agg_rr += 1
            train_batch, = get([agg.call("build_batch", ready_refs)],
                               timeout=AGGREGATE_TIMEOUT_S)
            collected = len(train_batch["obs"])
            num_fragments = len(ready_refs)
        else:
            fragments = get(ready_refs, timeout=SYNC_TIMEOUT_S)
            collected = sum(len(f) for f in fragments)
            num_fragments = len(fragments)
            builder = _Aggregator(self.module_spec, cfg.gamma, cfg.lam,
                                  cfg.vtrace_rho_clip)
            builder.set_weights(self.learner_group.get_weights())
            train_batch = builder.build_batch(fragments)
        self._timesteps += collected

        metrics = self.learner_group.update(
            train_batch, minibatch_size=cfg.minibatch_size,
            num_epochs=self._num_epochs(), shuffle_seed=self.iteration)

        self._since_broadcast += 1
        if self._since_broadcast >= cfg.broadcast_interval:
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
            self._sync_aggregators()
            self._since_broadcast = 0
        metrics["num_env_steps_trained"] = collected
        metrics["num_fragments"] = num_fragments
        return metrics

    def _num_epochs(self) -> int:
        return 1  # IMPALA: single pass per batch (APPO overrides)

    def stop(self):
        super().stop()
        for a in getattr(self, "_aggregators", ()):
            a.stop()
