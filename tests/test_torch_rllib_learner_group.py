"""The port's ``LearnerGroup`` over ``RankPool`` ranks on the CPU, runner
threads under PPO, and multi-agent configs.

Two CPU rank processes each hold a ``PPOLearner``; an update splits the
batch as the reference does (``ray_tpu/rllib/learner.py:215-222``) and
averages the full learner states (parameters, Adam moments, the int32
count) as ``:233-235`` do. The group is held against two reference
``PPOLearner``s run in this process on the batch halves, their states
averaged by numpy (no runtime cluster), within the tolerances of
``rllib_parity.py``, and against two local port learners averaged
the same way, bit for bit (the same torch code on the same CPU).
"""
import functools

import jax
import numpy as np
import pytest

from ray_tpu import rllib as R
from ray_tpu_torch import rllib as P
from ray_tpu_torch.rllib.learner import mean_state
from rllib_parity import (METRIC_RTOL, STATE_RTOL, ref_state, tree_err,
                          with_adam_state)
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(minibatch_size=32, num_epochs=2)


def _batch(seed, n=128):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "logp_old": np.full(n, np.log(0.5), np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def _spec(mod):
    return mod.RLModuleSpec(obs_dim=4, num_actions=2, hidden=(16, 16))


@pytest.fixture(scope="module")
def group():
    g = P.LearnerGroup(functools.partial(P.PPOLearner, _spec(P), seed=0),
                       num_learners=2, device="cpu")
    yield g
    g.stop()


def _pair_updates(make, seeds, to_state, set_state):
    """Two learners updated on the halves of each batch, their states
    averaged after each update; the metrics averaged."""
    pair = [make(), make()]
    metrics = []
    for seed in seeds:
        batch = _batch(seed)
        half = len(batch["obs"]) // 2
        ms = [p.update({k: v[lo:lo + half] for k, v in batch.items()},
                       shuffle_seed=seed, **KW)
              for p, lo in zip(pair, (0, half))]
        metrics.append({k: float(np.mean([m[k] for m in ms]))
                        for k in ms[0]})
        avg = mean_state([to_state(p) for p in pair])
        for p in pair:
            set_state(p, avg)
    return metrics, avg


def test_group_matches_two_averaged_learners(group):
    """Two updates of the rank group against (i) two reference learners
    on the halves, averaged by numpy after each update, within
    tolerance, and (ii) two local port learners averaged alike, bit for
    bit."""
    seeds = (5, 6)
    got_m = [group.update(_batch(s), shuffle_seed=s, **KW) for s in seeds]
    got = group.get_state()
    assert got["opt_state"]["count"].dtype == np.int32
    assert int(got["opt_state"]["count"]) == 2 * 4

    def set_ref(p, avg):
        p.params = avg["params"]
        p.opt_state = with_adam_state(p.opt_state, avg["opt_state"])

    ref_m, ref_avg = _pair_updates(
        lambda: R.PPOLearner(_spec(R), seed=0), seeds,
        lambda p: ref_state(p.get_state()), set_ref)
    for g, w in zip(got_m, ref_m):
        for k in w:
            assert abs(g[k] - w[k]) <= METRIC_RTOL * max(1.0, abs(w[k])), k
    assert tree_err(got, ref_avg) <= STATE_RTOL

    port_m, port_avg = _pair_updates(
        lambda: P.PPOLearner(_spec(P), seed=0, device="cpu"), seeds,
        lambda p: p.get_state(), lambda p, s: p.set_state(s))
    assert got_m == port_m
    assert tree_err(got, port_avg) == 0.0


def test_group_state_round_trip(group):
    """get_state / set_state through the ranks: every rank takes the
    state, and get_weights is rank 0's parameters."""
    state = group.get_state()
    bumped = jax.tree.map(lambda x: x + 1 if x.dtype.kind == "f" else x,
                          state)
    group.set_state(bumped)
    assert tree_err(group.get_state(), bumped) == 0.0
    assert tree_err(group.get_weights(), bumped["params"]) == 0.0
    group.set_state(state)


def test_mean_state_keeps_dtypes():
    a = {"p": np.array([1.0, 2.0], np.float32), "n": np.int32(3)}
    b = {"p": np.array([2.0, 5.0], np.float32), "n": np.int32(3)}
    m = mean_state([a, b])
    assert m["p"].dtype == np.float32 and m["p"].tolist() == [1.5, 3.5]
    assert m["n"].dtype == np.int32 and int(m["n"]) == 3


def test_remote_env_runners_are_refused():
    """No longer refused: ``num_env_runners=2`` builds two runners on
    threads of this process (the reference's remote runners are runtime
    actors), and PPO's iteration samples one fragment from each, in
    runner order, and broadcasts to both."""
    algo = (P.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .rl_module(hidden=(16, 16))
            .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
            .learners(device="cpu").debugging(seed=0)).build()
    try:
        assert algo.env_runner_group.local is None
        m = algo.train()
        assert m["num_env_steps_trained"] == 64
        weights = algo.learner_group.get_weights()
        for runner in algo.env_runner_group.remote:
            assert tree_err(runner._obj.module.params, weights) == 0.0
    finally:
        algo.stop()


@pytest.mark.parametrize("config", ["PPOConfig", "DQNConfig"])
def test_multi_agent_build_is_refused(config):
    """Multi-agent PPO is built (a MultiAgentPPO); every other algorithm
    still refuses ``.multi_agent(...)`` with the reference's message."""
    from test_rllib_multi_agent import ParallelPairEnv

    cfg = (getattr(P, config)().environment(env_creator=ParallelPairEnv)
           .multi_agent(policies={"a_0": None, "a_1": None})
           .rl_module(hidden=(8,))
           .learners(device="cpu"))
    if config == "PPOConfig":
        algo = cfg.build()
        algo.stop()
        assert isinstance(algo, P.MultiAgentPPO)
        assert set(algo.learner_group.groups) == {"a_0", "a_1"}
        return
    with pytest.raises(NotImplementedError,
                       match="multi-agent training is available for PPO"):
        cfg.build()


def test_ppo_trains_on_rank_learners():
    """``.learners(num_learners=2, device="cpu")``: PPO's iterations run
    on two CPU ranks and sync the runner from rank 0's weights."""
    algo = (P.PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .rl_module(hidden=(16, 16))
            .training(train_batch_size=64, minibatch_size=16, num_epochs=1)
            .learners(num_learners=2, device="cpu")
            .debugging(seed=0)).build()
    try:
        m = algo.train()
        assert np.isfinite(m["total_loss"]) and algo.iteration == 1
        runner = algo.env_runner_group.local.module.params
        assert tree_err(runner, algo.learner_group.get_weights()) == 0.0
        assert int(algo.learner_group.get_state()[
            "opt_state"]["count"]) == 2
    finally:
        algo.stop()
