"""The port's IMPALA and APPO (``ray_tpu_torch.rllib.impala``, ``appo``)
and its runner threads against the JAX reference on the CPU.

The reference's IMPALA runs only on remote runners (``impala.py:89-91``),
actors of its runtime, which these tests do not start; and which
fragment arrives first is not deterministic in either package. So
parity is held per piece: the thread runners' fragments against
reference runners built in this process at the seeds the reference
gives its remote runners (``seed + 1000 * (i + 1)``), bit for bit; the
aggregator's V-trace batch from the same fragments and weights (numpy
in both, within ``AGG_TOL``); and one IMPALA update (a single pass) and
one APPO update (``num_epochs``) from the same batch, within
``rllib_parity.py``'s tolerances. The algorithms themselves run as the
reference's smoke tests run them.
"""
import numpy as np
import pytest

from ray_tpu import rllib as R
from ray_tpu.rllib import env_runner as renv
from ray_tpu.rllib import impala as rimp
from ray_tpu_torch import rllib as P
from ray_tpu_torch.rllib import impala as pimp
from rllib_parity import METRIC_RTOL, STATE_RTOL, metric_err, ref_state, \
    tree_err
from torch_threads import one_torch_thread  # noqa: F401

#: The aggregator's batch, relative to max(|value|, 1) (both packages
#: compute it in the same numpy).
AGG_TOL = 1e-6


class _Frames:
    """84x84x4 frames, 6 actions (the shape of bench_rl.py's Pong-shaped
    env), 12-step episodes."""

    class _Space:
        def __init__(self, shape=None, n=None):
            self.shape, self.n = shape, n

    observation_space = _Space(shape=(84, 84, 4))
    action_space = _Space(n=6)

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return self._rng.random((84, 84, 4), np.float32), {}

    def step(self, action):
        self._t += 1
        return (self._rng.random((84, 84, 4), np.float32),
                float(action == 3), self._t >= 12, False, {})


def _spec(mod, conv):
    if conv:
        return mod.RLModuleSpec(obs_dim=84 * 84 * 4, num_actions=6,
                                hidden=(64,), obs_shape=(84, 84, 4),
                                conv=True)
    return mod.RLModuleSpec(obs_dim=4, num_actions=2, hidden=(16, 16))


def _fragments(conv, n=2):
    """``n`` fragments from a reference runner (seed 1) acting with the
    seed-1 weights; the aggregator scores them under seed-2 weights, so
    the ratios are not all 1."""
    import gymnasium

    env = _Frames if conv else (lambda: gymnasium.make("CartPole-v1"))
    runner = renv.SingleAgentEnvRunner(env, _spec(R, conv), num_envs=2,
                                       rollout_fragment_length=12, seed=1)
    return [runner.sample() for _ in range(n)], \
        _spec(R, conv).build(2).get_weights()


@pytest.mark.parametrize("conv", [False, True], ids=["mlp", "nature_cnn"])
def test_aggregator_build_batch_matches_reference(conv):
    frags, weights = _fragments(conv)
    args = (0.99, 0.95, 1.0)
    ref = rimp._Aggregator(_spec(R, conv), *args)
    port = pimp._Aggregator(_spec(P, conv), *args)
    ref.set_weights(weights)
    port.set_weights(weights)
    want = ref.build_batch(frags)
    got = port.build_batch(frags)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
    assert metric_err(got, want) <= AGG_TOL
    assert (want["advantages"] != 0).any()


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_update_matches_reference(algo):
    """IMPALA's update (one pass, minibatch 128) and APPO's (two epochs,
    minibatch 256) on an aggregated batch, from the same weights, at the
    configs' defaults."""
    cfg = (R.IMPALAConfig if algo == "impala" else R.APPOConfig)()
    epochs = 1 if algo == "impala" else cfg.num_epochs
    frags, weights = _fragments(False, n=12)
    agg = rimp._Aggregator(_spec(R, False), cfg.gamma, cfg.lam,
                           cfg.vtrace_rho_clip)
    agg.set_weights(weights)
    batch = agg.build_batch(frags)
    assert len(batch["obs"]) == 288
    kw = dict(lr=cfg.lr, clip_param=cfg.clip_param, vf_coeff=cfg.vf_coeff,
              entropy_coeff=cfg.entropy_coeff, grad_clip=cfg.grad_clip,
              seed=0)
    ref = R.PPOLearner(_spec(R, False), **kw)
    port = P.PPOLearner(_spec(P, False), device="cpu", **kw)
    upd = dict(minibatch_size=cfg.minibatch_size, num_epochs=epochs,
               shuffle_seed=3)
    assert metric_err(port.update(batch, **upd),
                      ref.update(batch, **upd)) <= METRIC_RTOL
    got = port.get_state()
    assert int(got["opt_state"]["count"]) == epochs * (
        -(-288 // cfg.minibatch_size))
    assert tree_err(got, ref_state(ref.get_state())) <= STATE_RTOL


def test_runner_threads_match_reference_runners():
    """``EnvRunnerGroup(num_env_runners=2)`` samples on two threads;
    runner i's fragments (``sample()`` in runner order, then IMPALA's
    ``sample_async_refs``) equal a reference ``SingleAgentEnvRunner``'s
    at seed ``seed + 1000 * (i + 1)`` after the same weight sync."""
    import threading

    import gymnasium

    def env():
        return gymnasium.make("CartPole-v1")

    group = P.EnvRunnerGroup(env, _spec(P, False), num_env_runners=2,
                             num_envs_per_runner=2,
                             rollout_fragment_length=40, seed=7)
    refs = [renv.SingleAgentEnvRunner(env, _spec(R, False), 2, 40,
                                      seed=7 + 1000 * (i + 1))
            for i in range(2)]
    try:
        assert group.local is None and len(group.remote) == 2
        names = {t.name for t in threading.enumerate()}
        assert {"SingleAgentEnvRunner-0_0",
                "SingleAgentEnvRunner-1_0"} <= names
        weights = _spec(P, False).build(9).get_weights()
        group.sync_weights(weights)
        for r in refs:
            r.set_weights(weights)
        got = group.sample() + [
            f.result(timeout=60) for _, f in group.sample_async_refs()]
        want = [r.sample() for r in refs] + [r.sample() for r in refs]
        for g, w in zip(got, want):
            assert set(g.cols) == set(w.cols)
            for k in w.cols:
                assert g[k].dtype == w[k].dtype
                assert np.array_equal(g[k], w[k]), k
        metrics = group.get_metrics()
        ms = [r.get_metrics() for r in refs]
        assert metrics["num_episodes"] == sum(m["num_episodes"] for m in ms)
        assert metrics["episode_return_max"] == max(
            m["episode_return_max"] for m in ms)
    finally:
        group.stop()


def test_impala_async():
    """The reference's test_impala_async (tests/test_rllib.py:109) on
    runner threads."""
    cfg = (P.IMPALAConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                        rollout_fragment_length=32)
           .training(minibatch_size=128)
           .learners(device="cpu")
           .debugging(seed=0))
    algo = cfg.build()
    try:
        for _ in range(5):
            m = algo.train()
        assert m["num_env_steps_sampled_lifetime"] >= 5 * 128
        assert m["num_fragments"] >= 1
        assert np.isfinite(m["total_loss"])
        # the broadcast reached the runner threads
        runner = algo.env_runner_group.remote[0]._obj.module.params
        assert tree_err(runner, algo.learner_group.get_weights()) == 0.0
    finally:
        algo.stop()


def test_appo_smoke():
    """The reference's test_appo_smoke (tests/test_rllib_depth.py:112),
    one aggregator thread."""
    config = (P.APPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=64)
              .training(train_batch_size=256, minibatch_size=128,
                        num_epochs=2, lr=5e-4)
              .learners(device="cpu")
              .debugging(seed=0))
    config.num_aggregation_workers = 1
    algo = config.build()
    try:
        for _ in range(3):
            m = algo.train()
        assert np.isfinite(m["total_loss"])
        assert m["num_env_steps_trained"] > 0
    finally:
        algo.stop()


def test_impala_cnn_aggregator_smoke():
    """The reference's test_impala_cnn_aggregator_smoke
    (tests/test_rllib_depth.py:131): an 84x84 image env through
    FrameStack connectors, the Nature-CNN module, an aggregator."""
    import gymnasium as gym

    def env_creator():
        class TinyImageEnv(gym.Env):
            observation_space = gym.spaces.Box(0, 255, (84, 84, 1),
                                               np.uint8)
            action_space = gym.spaces.Discrete(4)

            def reset(self, seed=None, options=None):
                self._t = 0
                return self.observation_space.sample(), {}

            def step(self, action):
                self._t += 1
                obs = self.observation_space.sample()
                return obs, float(action == 1), self._t >= 20, False, {}

        return TinyImageEnv()

    config = (P.IMPALAConfig()
              .environment(env_creator=env_creator)
              .env_runners(
                  num_env_runners=1, num_envs_per_env_runner=1,
                  rollout_fragment_length=16,
                  env_to_module_connector=lambda: P.ConnectorPipeline(
                      [P.NormalizeObs(scale=1 / 255.0), P.FrameStack(k=2)]))
              .rl_module(use_conv=True, hidden=(64,))
              .training(train_batch_size=16, minibatch_size=16, lr=1e-4)
              .learners(device="cpu")
              .debugging(seed=0))
    config.num_aggregation_workers = 1
    algo = config.build()
    try:
        m = algo.train()
        assert np.isfinite(m["total_loss"])
    finally:
        algo.stop()


def test_impala_needs_runners():
    """``num_env_runners == 0`` is refused, as the reference refuses it."""
    cfg = (P.IMPALAConfig().environment("CartPole-v1")
           .learners(device="cpu"))
    with pytest.raises(ValueError, match="requires num_env_runners >= 1"):
        cfg.build()
