"""The port's multi-agent RL (``ray_tpu_torch.rllib.multi_agent``) and its
runner threads against the JAX reference on the CPU.

The acting side is numpy in both packages (copied), so the same seeds
give the same modules, the same per-(env, agent, module) streams and
the same fragments, bit for bit: on a parallel env, on a turn-based env
whose rewards arrive a step late, and on runner threads, which are held
against reference runners built in this process at the seeds the
reference gives its remote runners (``seed + 1000 * (i + 1)``; those
remote runners need the reference's runtime, which this test does not
start). Learners are compared as in ``rllib_parity.py``.
"""
import numpy as np
import pytest

from ray_tpu import rllib as R
from ray_tpu.rllib import multi_agent as rma
from ray_tpu_torch import rllib as P
from ray_tpu_torch.rllib import multi_agent as pma
from rllib_parity import METRIC_RTOL, STATE_RTOL, metric_err, ref_state, \
    tree_err
from test_rllib_multi_agent import (CooperativeCorridor, IdleFrameEnv,
                                    ParallelPairEnv, TurnBasedEnv)
from torch_threads import one_torch_thread  # noqa: F401


def _specs(mod, env_cls, mapping=None):
    env = env_cls()
    mapping = mapping or (lambda aid, i: aid)
    return {mapping(a, 0): mod.spec_from_spaces(env.observation_spaces[a],
                                                env.action_spaces[a],
                                                hidden=(16,))
            for a in env.possible_agents}


def _equal_batches(got: dict, want: dict):
    assert set(got) == set(want)
    for mid in want:
        assert set(got[mid].cols) == set(want[mid].cols), mid
        for k, v in want[mid].cols.items():
            assert got[mid][k].dtype == v.dtype, (mid, k)
            assert np.array_equal(got[mid][k], v), (mid, k)


@pytest.mark.parametrize("env_cls,envs,fragment,mapping", [
    (ParallelPairEnv, 2, 7, None),
    (TurnBasedEnv, 2, 9, None),
    (IdleFrameEnv, 1, 11, None),
    (ParallelPairEnv, 2, 6, lambda aid, i: "shared"),
], ids=["parallel", "turn_based", "idle_frames", "shared_module"])
def test_runner_sample_matches_reference(env_cls, envs, fragment, mapping):
    """Three fragments, so transitions left open at a fragment's end (and
    delayed rewards, and successor values filled in when the agent next
    acts) carry across; every column and every stream length equal."""
    mapping = mapping or (lambda aid, i: aid)
    ref = rma.MultiAgentEnvRunner(env_cls, _specs(R, env_cls, mapping),
                                  mapping, envs, fragment, seed=4)
    port = pma.MultiAgentEnvRunner(env_cls, _specs(P, env_cls, mapping),
                                   mapping, envs, fragment, seed=4)
    for _ in range(3):
        _equal_batches(port.sample(), ref.sample())
    assert port.get_metrics() == ref.get_metrics()


def test_multi_rl_module_builds_in_sorted_order():
    """Module ``i`` in sorted id order gets seed ``seed + i``, whatever
    order the ids come in."""
    specs = _specs(P, ParallelPairEnv)
    got = P.MultiRLModule(dict(reversed(list(specs.items()))), seed=3)
    want = R.MultiRLModule(_specs(R, ParallelPairEnv), seed=3)
    assert tree_err(got.get_weights(), want.get_weights()) == 0.0


def _ma_ppo(mod, env_cls=ParallelPairEnv, **kw):
    cfg = (mod.PPOConfig().environment(env_creator=env_cls)
           .multi_agent(policies={"first", "second"} if env_cls is
                        TurnBasedEnv else {"a_0", "a_1"},
                        policy_mapping_fn=lambda aid, i: aid, **kw)
           .env_runners(num_envs_per_env_runner=2,
                        rollout_fragment_length=16)
           .rl_module(hidden=(16,))
           .training(train_batch_size=64, minibatch_size=32, num_epochs=2)
           .debugging(seed=1))
    if mod is P:
        cfg.learners(device="cpu")
    return cfg.build()


@pytest.mark.parametrize("env_cls", [ParallelPairEnv, TurnBasedEnv],
                         ids=["parallel", "turn_based"])
def test_multi_agent_ppo_step_matches_reference(env_cls):
    """``PPOConfig().multi_agent(...).build()`` is a MultiAgentPPO; two
    iterations (per-stream GAE, each module's update, the broadcast)
    give each module's metrics and learner state within tolerance."""
    ref, port = _ma_ppo(R, env_cls), _ma_ppo(P, env_cls)
    try:
        assert isinstance(port, P.MultiAgentPPO)
        for _ in range(2):
            m_ref, m_port = ref.train(), port.train()
            keys = [k for k in m_ref if k.startswith("module/")
                    or k in ("num_env_steps_trained", "num_episodes",
                             "episode_return_mean")]
            assert any(k.endswith("total_loss") for k in keys)
            assert metric_err(m_port, {k: m_ref[k] for k in keys}) \
                <= METRIC_RTOL
        want = ref.learner_group.get_state()
        got = port.learner_group.get_state()
        assert set(got) == set(want)
        for mid in want:
            assert tree_err(got[mid], ref_state(want[mid])) <= STATE_RTOL
        runner = port.env_runner_group.local.marl_module.get_weights()
        assert tree_err(runner, port.learner_group.get_weights()) == 0.0
    finally:
        ref.stop()
        port.stop()


def test_multi_agent_checkpoint_roundtrip(tmp_path):
    algo = _ma_ppo(P)
    try:
        algo.train()
        path = algo.save_to_path(str(tmp_path / "ckpt"))
        saved = algo.learner_group.get_state()
        algo.train()
        algo.restore_from_path(path)
        assert tree_err(algo.learner_group.get_state(), saved) == 0.0
        runner = algo.env_runner_group.local.marl_module.get_weights()
        assert tree_err(runner, {m: s["params"] for m, s in
                                 saved.items()}) == 0.0
    finally:
        algo.stop()


def test_policies_to_train_freezes_others():
    algo = _ma_ppo(P, policies_to_train=["a_0"])
    try:
        w0 = algo.learner_group.get_weights()
        m = algo.train()
        assert any(k.startswith("module/a_0/") for k in m)
        assert not any(k.startswith("module/a_1/") and "loss" in k
                       for k in m)
        w = algo.learner_group.get_weights()
        assert tree_err(w["a_1"], w0["a_1"]) == 0.0
        assert not np.array_equal(w["a_0"]["logits"]["w"],
                                  w0["a_0"]["logits"]["w"])
    finally:
        algo.stop()


def test_multi_agent_runner_threads_match_reference_seeds():
    """``num_env_runners=2``: two runners on threads, runner i seeded
    ``seed + 1000 * (i + 1)``; after a weight sync each one's fragments
    equal a reference runner's built locally at that seed, and the
    group's metrics aggregate as the reference's do."""
    specs = _specs(P, TurnBasedEnv)
    group = P.MultiAgentEnvRunnerGroup(
        TurnBasedEnv, specs, lambda aid, i: aid, num_env_runners=2,
        num_envs_per_runner=2, rollout_fragment_length=9, seed=5)
    refs = [rma.MultiAgentEnvRunner(TurnBasedEnv, _specs(R, TurnBasedEnv),
                                    lambda aid, i: aid, 2, 9,
                                    seed=5 + 1000 * (i + 1))
            for i in range(2)]
    try:
        assert group.local is None and len(group.remote) == 2
        weights = P.MultiRLModule(specs, seed=11).get_weights()
        group.sync_weights(weights)
        for r in refs:
            r.set_weights(weights)
        for _ in range(2):
            for got, want in zip(group.sample(), [r.sample() for r in refs]):
                _equal_batches(got, want)
        metrics = group.get_metrics()
        ms = [r.get_metrics() for r in refs]
        assert metrics["num_episodes"] == sum(m["num_episodes"] for m in ms)
        assert metrics["episode_return_mean"] == pytest.approx(np.mean(
            [m["episode_return_mean"] for m in ms]))
    finally:
        group.stop()


def test_multi_agent_ppo_learns_cooperative_corridor():
    """The reference's gate (tests/test_rllib_multi_agent.py:283-313) at
    its configuration: the best joint return reaches 2.0 within 40
    iterations."""
    config = (
        P.PPOConfig()
        .environment(env_creator=CooperativeCorridor)
        .multi_agent(policies={"left", "right"},
                     policy_mapping_fn=lambda aid, i: aid)
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                     rollout_fragment_length=128)
        .rl_module(hidden=(32, 32))
        .training(train_batch_size=2048, minibatch_size=256,
                  num_epochs=6, lr=3e-4, entropy_coeff=0.01)
        .learners(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build()
    try:
        best = -np.inf
        for _ in range(40):
            m = algo.train()
            best = max(best, m.get("episode_return_mean", -np.inf))
            if best >= 2.0:
                break
        assert best >= 2.0, best
        assert "module/left/episode_return_mean" in m
        assert any(k.startswith("module/left/") and k.endswith("total_loss")
                   for k in m)
    finally:
        algo.stop()


def test_continuous_modules_are_refused():
    from test_rllib_multi_agent import _Box

    class _Cont:
        shape = (1,)
        low = np.array([-1.0], np.float32)
        high = np.array([1.0], np.float32)

    spec = P.spec_from_spaces(_Box((3,)), _Cont(), hidden=(8,))
    cfg = (P.PPOConfig().environment(env_creator=ParallelPairEnv)
           .multi_agent(policies={"a_0": spec})
           .learners(device="cpu"))
    with pytest.raises(NotImplementedError, match="discrete actions only"):
        cfg.build()
