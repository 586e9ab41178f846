"""The port's rllib core (``ray_tpu_torch.rllib``) against the JAX
reference (``ray_tpu.rllib``) on the CPU: modules, the optimiser, GAE
and PPO.

Both packages start from the same numpy weights (the reference's
initialisers, copied, give them for the same seed) and batches made from
numpy seeds. Tolerances, f32 throughout:

- a forward: ``FWD_RTOL`` relative to the output's largest magnitude;
- after updates, every parameter and Adam-moment leaf within
  ``STATE_RTOL`` of the reference's and every metric within
  ``METRIC_RTOL`` (``rllib_parity.py`` says relative to what, and why);
- the rollouts are numpy in both packages, so a ``SampleBatch`` and GAE
  are bit-equal.
"""
import importlib.util
import inspect
import os
import pickle

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import rllib as R
from ray_tpu.rllib import conv_module as rconv
from ray_tpu.rllib import rl_module as rmod
from ray_tpu_torch import rllib as P
from ray_tpu_torch._private.device import full_f32
from ray_tpu_torch.rllib import _optim
from ray_tpu_torch.rllib import conv_module as pconv
from ray_tpu_torch.rllib import rl_module as pmod
from rllib_parity import (METRIC_RTOL, STATE_RTOL, metric_err, ref_state,
                          tree_err, with_adam_state)
from torch_threads import one_torch_thread  # noqa: F401

FWD_RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec(mod, **kw):
    return mod.RLModuleSpec(**kw)


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("kind", ["mlp", "conv", "sac"])
def test_init_params_bit_equal(kind):
    """The copied numpy initialisers give the reference's weights."""
    from ray_tpu.rllib import sac as rsac
    from ray_tpu_torch.rllib import sac as psac

    kw = dict(obs_dim=6, num_actions=3, hidden=(16, 8))
    if kind == "mlp":
        got, want = pmod._init_mlp(_spec(P, **kw), 5), \
            rmod._init_mlp(_spec(R, **kw), 5)
    elif kind == "conv":
        kw.update(obs_shape=(42, 42, 4), conv=True, hidden=(32,))
        got, want = pconv.init_conv_params(_spec(P, **kw), 5), \
            rconv.init_conv_params(_spec(R, **kw), 5)
    else:
        got, want = psac.init_sac_params(_spec(P, **kw), 5), \
            rsac.init_sac_params(_spec(R, **kw), 5)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mlp_forward_matches_reference():
    spec = _spec(R, obs_dim=7, num_actions=4, hidden=(32, 16))
    params = rmod._init_mlp(spec, 3)
    obs = np.random.default_rng(0).standard_normal((9, 7)).astype(
        np.float32)
    want_np = rmod.mlp_forward(params, obs, np)
    want_jax = rmod.mlp_forward(params, obs, jnp)
    got_np = pmod.mlp_forward(params, obs, np)
    got = pmod.mlp_forward(pmod.params_to_torch(params, "cpu"),
                           torch.from_numpy(obs), torch)
    for g, gn, wn, wj in zip(got, got_np, want_np, want_jax):
        assert np.array_equal(gn, wn)
        for w in (wn, np.asarray(wj)):
            assert g.dtype == torch.float32
            assert np.abs(g.numpy() - w).max() <= FWD_RTOL * np.abs(w).max()


def test_conv_forward_matches_reference():
    """The torch path (F.conv2d on an NCHW view of NHWC, HWIO weights
    permuted, NHWC flatten) against ``lax.conv`` and the numpy im2col."""
    spec = _spec(R, obs_dim=42 * 42 * 4, num_actions=6, hidden=(64,),
                 obs_shape=(42, 42, 4), conv=True)
    params = rconv.init_conv_params(spec, 1)
    obs = np.random.default_rng(1).random((5, 42, 42, 4), np.float32)
    want_np = rconv.conv_forward(params, obs, np)
    want_jax = rconv.conv_forward(params, obs, jnp)
    got = pconv.conv_forward(pmod.params_to_torch(params, "cpu"),
                             torch.from_numpy(obs), torch)
    got_np = pconv.conv_forward(params, obs, np)
    for g, gn, wn, wj in zip(got, got_np, want_np, want_jax):
        assert np.array_equal(gn, wn)
        for w in (np.asarray(wj), wn):
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_params_round_trip_copies():
    tree = {"a": [np.arange(3, dtype=np.float32)],
            "b": np.asarray(2.5, np.float32), "c": np.int32(4)}
    t = pmod.params_to_torch(tree, "cpu")
    t["a"][0] += 1
    assert tree["a"][0][0] == 0        # a copy, not a view
    back = pmod.params_to_numpy(t)
    assert back["b"].shape == () and back["b"].dtype == np.float32
    assert back["c"].dtype == np.int32 and int(back["c"]) == 4
    back["a"][0][0] = 9
    assert float(t["a"][0][0]) == 1.0


# ------------------------------------------------------------ optimiser
def _grad_trees(seed, steps, scale):
    rng = np.random.default_rng(seed)
    shapes = {"w": [(5, 3), (3,)], "head": {"b": (2,), "s": ()}}

    def draw(s, k=1.0):
        return np.asarray(k * rng.standard_normal(s), np.float32)

    is_shape = lambda x: isinstance(x, tuple)  # noqa: E731
    params = jax.tree.map(draw, shapes, is_leaf=is_shape)
    grads = [jax.tree.map(lambda s: draw(s, scale), shapes,
                          is_leaf=is_shape) for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("clip,scale", [(None, 1.0), (0.5, 1.0),
                                        (100.0, 1.0), (1.0, 1e-3)])
def test_optim_matches_optax(clip, scale):
    """Adam (and global-norm clipping, triggered or not) against optax's
    chain, step by step: parameters and moments within ``STATE_RTOL``
    (the norm sums in another order, so a clipped gradient parts by an
    ulp, and a moment whose terms cancel keeps that absolute error at a
    smaller size: 3.7e-6 of the 1e-3 floor measured), the count
    bit-equal; then the port's state exported into optax's
    ``ScaleByAdamState`` and optax's back, both continuing alike."""
    params, grads = _grad_trees(7, 6, scale)
    chain = [optax.adam(1e-2)] if clip is None else \
        [optax.clip_by_global_norm(clip), optax.adam(1e-2)]
    tx = optax.chain(*chain)
    opt = _optim.Adam(1e-2, grad_clip=clip)
    r_params, r_state = params, tx.init(params)
    p_params = pmod.params_to_torch(params, "cpu")
    p_state = opt.init(p_params)
    for i, g in enumerate(grads):
        upd, r_state = tx.update(g, r_state, r_params)
        r_params = optax.apply_updates(r_params, upd)
        p_params, p_state = opt.update(
            p_params, pmod.params_to_torch(g, "cpu"), p_state)
        got = pmod.params_to_numpy({"params": p_params,
                                    "opt_state": p_state})
        want = ref_state({"params": r_params, "opt_state": r_state})
        assert got["opt_state"]["count"].dtype == np.int32
        assert tree_err(got, want) <= STATE_RTOL, i
        if i == 2:
            # cross over: optax continues from the port's state, the port
            # from optax's
            r_state = with_adam_state(r_state, got["opt_state"])
            p_state = pmod.params_to_torch(want["opt_state"], "cpu")
            r_params, p_params = got["params"], pmod.params_to_torch(
                want["params"], "cpu")


def test_global_norm_clip_is_optax_not_clip_grad_norm():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    got = _optim.clip_by_global_norm(g, 1.0)
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(x.numpy()) for x in g], None)[0]
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert float(_optim.global_norm(g)) == 13.0


def test_full_f32_restores_the_flags():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ------------------------------------------------------------ GAE, PPO
@pytest.mark.parametrize("with_rho", [False, True])
def test_compute_gae_equal(with_rho):
    rng = np.random.default_rng(4)
    T, N = 16, 3
    cols = [rng.standard_normal(T * N).astype(np.float32) for _ in range(3)]
    dones = rng.random(T * N) < 0.1
    truncs = rng.random(T * N) < 0.05
    rho = rng.random(T * N).astype(np.float32) * 2 if with_rho else None
    got = P.compute_gae(*cols, dones, truncs, [T, N], rho=rho)
    want = R.compute_gae(*cols, dones, truncs, [T, N], rho=rho)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _ppo(mod, **kw):
    cfg = (mod.PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .training(train_batch_size=256, minibatch_size=64, num_epochs=3)
           .debugging(seed=0))
    if mod is P:
        cfg.learners(device="cpu")
    return cfg.training(**kw).build()


def _record_samples(algo):
    seen = []
    sample = algo.env_runner_group.local.sample

    def wrapped():
        seen.append(sample())
        return seen[-1]

    algo.env_runner_group.local.sample = wrapped
    return seen


def test_sample_with_len_is_sample():
    """``SingleAgentEnvRunner.sample_with_len`` is the reference's alias
    of ``sample`` (``ray_tpu/rllib/env_runner.py:166``): two runners from
    one seed give the same fragment through each."""
    from ray_tpu.rllib.env_runner import SingleAgentEnvRunner as RRunner
    from ray_tpu_torch.rllib.env_runner import SingleAgentEnvRunner

    assert inspect.signature(SingleAgentEnvRunner.sample_with_len) == \
        inspect.signature(RRunner.sample_with_len)
    a, b = (_ppo(P).env_runner_group.local for _ in range(2))
    got, want = b.sample_with_len(), a.sample()
    assert sorted(got.cols) == sorted(want.cols) and len(got) == 128
    for k in want.cols:
        assert np.array_equal(got[k], want[k]), k


def test_ppo_iteration_matches_reference():
    """One PPO iteration on CartPole-v1 from seed 0: both sampled
    fragments bit-equal (same numpy weights, runner and env), then the last
    minibatch's metrics and the learner state after 3 epochs of 4
    minibatches within tolerance."""
    ref, port = _ppo(R), _ppo(P)
    try:
        seen = {"ref": _record_samples(ref), "port": _record_samples(port)}
        m_ref, m_port = ref.train(), port.train()
        assert len(seen["ref"]) == len(seen["port"]) == 2
        for b_ref, b_port in zip(seen["ref"], seen["port"]):
            assert set(b_ref.cols) == set(b_port.cols)
            for k in b_ref.cols:
                assert b_ref[k].dtype == b_port[k].dtype, k
                assert np.array_equal(b_ref[k], b_port[k]), k
        keys = ("policy_loss", "vf_loss", "entropy", "total_loss",
                "num_env_steps_trained", "episode_return_mean")
        assert metric_err(m_port, {k: m_ref[k] for k in keys}) <= METRIC_RTOL
        want = ref_state(ref.learner_group.get_state())
        got = port.learner_group.get_state()
        assert int(got["opt_state"]["count"]) == 12
        assert tree_err(got, want) <= STATE_RTOL
    finally:
        ref.stop()
        port.stop()


def test_ppo_conv_learner_matches_reference():
    """The Nature-CNN PPO learner (42x42x4, torso 64) on the same batch:
    two epochs of two minibatches."""
    kw = dict(obs_dim=42 * 42 * 4, num_actions=6, hidden=(64,),
              obs_shape=(42, 42, 4), conv=True)
    rng = np.random.default_rng(2)
    n = 64
    batch = {"obs": rng.random((n, 42, 42, 4), np.float32),
             "actions": rng.integers(0, 6, n),
             "logp_old": np.full(n, np.log(1 / 6), np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}
    ref = R.PPOLearner(_spec(R, **kw), seed=3)
    port = P.PPOLearner(_spec(P, **kw), seed=3, device="cpu")
    m_ref = ref.update(batch, minibatch_size=32, num_epochs=2)
    m_port = port.update(batch, minibatch_size=32, num_epochs=2)
    assert metric_err(m_port, m_ref) <= METRIC_RTOL
    assert tree_err(port.get_state(), ref_state(ref.get_state())) \
        <= STATE_RTOL


def test_ppo_checkpoint_round_trip(tmp_path):
    """save_to_path writes numpy only; a fresh algorithm restored from it
    holds the same state, syncs its runner, and trains on."""
    algo = _ppo(P)
    try:
        algo.train()
        algo.save_to_path(str(tmp_path))
        saved = algo.learner_group.get_state()
    finally:
        algo.stop()
    with open(tmp_path / "algo_state.torch.pkl", "rb") as f:
        raw = pickle.load(f)
    assert all(isinstance(x, np.ndarray)
               for x in jax.tree.leaves(raw["learner"]))
    assert raw["iteration"] == 1 and raw["timesteps"] == 256
    fresh = _ppo(P)
    try:
        fresh.restore_from_path(str(tmp_path))
        assert tree_err(fresh.learner_group.get_state(), saved) == 0.0
        runner = fresh.env_runner_group.local.module.params
        assert tree_err(runner, saved["params"]) == 0.0
        assert fresh.iteration == 1
        m = fresh.train()
        assert np.isfinite(m["total_loss"]) and fresh.iteration == 2
    finally:
        fresh.stop()


def test_ppo_learns_cartpole_fast():
    """The reference's learning gate (tests/test_rllib.py:58) on the
    port, at that test's configuration."""
    algo = (P.PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(train_batch_size=1024, minibatch_size=256,
                      num_epochs=6, lr=3e-4, entropy_coeff=0.001)
            .learners(device="cpu")
            .debugging(seed=0)).build()
    try:
        best = 0.0
        for _ in range(25):
            m = algo.train()
            best = max(best, m["episode_return_mean"])
        assert best >= 120, f"PPO failed to learn: best={best}"
    finally:
        algo.stop()


def test_learners_need_a_card_unless_told():
    """No device means the card: without one a learner raises rather
    than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    spec = _spec(P, obs_dim=4, num_actions=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.PPOLearner(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.PPOConfig().environment("CartPole-v1").build()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("conv,seed", [(False, 21), (True, 21),
                                       (True, 12)])
def test_chip_smoke_hold_covers_f32_rounding(conv, seed):
    """chip_smoke.py holds a learner on the card to the CPU's at f32
    (``_rl_hold``: dense learners within RL_TOL; conv learners by their
    Adam moments within RL_CONV_TOL and at most RL_FLIPS of their
    parameters past RL_TOL). The CPU's own f32 update, held the same way
    to an f64 run of it (rounded to f32), passes: the bounds are f32
    rounding's size. On the 64x64 MLP (tanh) that is ~1e-6. On the
    Nature-CNN at rl_phase's (c) shape (84x84x4, torso 512, minibatch
    128) a ReLU input within rounding of 0 (2.8M of them) can be on in
    one run and off in the other: at seed 12 one conv3 input is, and its
    term alone moves conv gradients by 1.2e-3 of their leaf's largest,
    which Adam carries into the moments and turns into ±lr steps for
    gradients near 0. ``-s`` prints the measures."""
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)
    n = 128
    if conv:
        shape, actions = (84, 84, 4), 6
        spec = _spec(P, obs_dim=84 * 84 * 4, num_actions=actions,
                     hidden=(512,), obs_shape=shape, conv=True)
    else:
        shape, actions = (4,), 2
        spec = _spec(P, obs_dim=4, num_actions=actions, hidden=(64, 64))
    batch = {"obs": rng.random((n,) + shape, np.float32),
             "actions": rng.integers(0, actions, n),
             "logp_old": (np.log(1.0 / actions) + 0.1
                          * rng.standard_normal(n)).astype(np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}
    states = {}
    for dtype in (torch.float32, torch.float64):
        learner = P.PPOLearner(spec, seed=0, device="cpu")
        learner.params, learner.opt_state = jax.tree.map(
            lambda t: t.to(dtype) if t.is_floating_point() else t,
            (learner.params, learner.opt_state))
        learner.update({k: v.astype(np.float64) if dtype == torch.float64
                        and v.dtype.kind == "f" else v
                        for k, v in batch.items()})
        states[dtype] = jax.tree.map(
            lambda x: x.astype(np.float32) if x.dtype.kind == "f" else x,
            learner.get_state())
    ok, text = cs._rl_hold(states[torch.float32], states[torch.float64],
                           conv=conv)
    print(f"f32 vs f64, {'Nature-CNN' if conv else 'MLP'}, seed {seed}: "
          f"{text}")
    assert ok, text


def test_chip_smoke_cartpole_is_gymnasiums():
    """chip_smoke.py's numpy CartPole (the card's machine has no
    gymnasium) steps as ``gymnasium.make("CartPole-v1")`` does: seeded
    resets, observations, rewards, termination and the 500-step
    truncation."""
    mine, gym = _chip_smoke().make_cartpole(), gymnasium.make("CartPole-v1")
    assert mine.observation_space.shape == gym.observation_space.shape
    assert mine.action_space.n == gym.action_space.n
    rng = np.random.default_rng(0)
    ends = {"term": 0, "trunc": 0}
    for episode in range(6):
        seed = 10 + episode if episode % 2 == 0 else None
        a, b = mine.reset(seed=seed)[0], gym.reset(seed=seed)[0]
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for t in range(600):
            # a balancing policy for the first episodes (truncation),
            # random actions after
            act = int(a[2] + 0.5 * a[3] > 0) if episode < 2 else \
                int(rng.integers(2))
            ra, rb = mine.step(act), gym.step(act)
            for x, y in zip(ra[:4], rb[:4]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), t
            a = ra[0]
            if ra[2] or ra[3]:
                ends["term" if ra[2] else "trunc"] += 1
                break
    assert ends["term"] >= 1 and ends["trunc"] >= 1, ends
