"""The port's off-policy and offline learners (``ray_tpu_torch.rllib``:
DQN, SAC, CQL, BC, MARWIL) against the JAX reference's on the CPU.

Both packages start from the same numpy weights and see the same
batches (numpy seeds; the replay buffers and offline samplers are numpy
in both, so they hand both learners the same rows). Every metric within
``METRIC_RTOL`` and every parameter, target and Adam moment within
``STATE_RTOL`` (``rllib_parity.py``).
SAC's noise is drawn along the reference's key chain with the port's
threefry, bit-equal to ``jax.random``.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from ray_tpu import rllib as R
from ray_tpu.rllib import dqn as rdqn
from ray_tpu.rllib import sac as rsac
from ray_tpu_torch import rllib as P
from ray_tpu_torch._private import prng
from ray_tpu_torch.rllib import dqn as pdqn
from ray_tpu_torch.rllib import sac as psac
from rllib_parity import METRIC_RTOL, STATE_RTOL, adam_state, metric_err, \
    tree_err

def transitions(rng, n, obs_dim, act, continuous):
    b = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "dones": (rng.random(n) < 0.1).astype(np.float32)}
    b["actions"] = (rng.uniform(-1, 1, (n, act)).astype(np.float32)
                    if continuous else rng.integers(0, act, n))
    return b


# ------------------------------------------------------------------ DQN
@pytest.mark.parametrize("conv,weights", [(False, True), (False, False),
                                          (True, True)])
def test_dqn_learner_matches_reference(conv, weights):
    """Double-DQN updates (importance weights or none, a target sync
    after the second) on an MLP and a 42x42x4 conv Q-net."""
    kw = dict(obs_dim=4, num_actions=3, hidden=(32, 32))
    if conv:
        kw.update(obs_dim=42 * 42 * 4, obs_shape=(42, 42, 4), conv=True,
                  hidden=(64,))
    ref = rdqn.DQNLearner(R.RLModuleSpec(
        **kw, module_cls=rdqn.EpsilonGreedyModule), seed=2)
    port = pdqn.DQNLearner(P.RLModuleSpec(
        **kw, module_cls=pdqn.EpsilonGreedyModule), seed=2, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(4):
        b = transitions(rng, 32, kw["obs_dim"], 3, False)
        if conv:
            b["obs"] = rng.random((32, 42, 42, 4), np.float32)
            b["next_obs"] = rng.random((32, 42, 42, 4), np.float32)
        if weights:
            b["weights"] = rng.random(32).astype(np.float32)
        m_ref, m_port = ref.update(b), port.update(b)
        assert metric_err(m_port, m_ref) <= METRIC_RTOL, i
        if i == 1:
            ref.sync_target()
            port.sync_target()
    want = ref.get_state()
    got = port.get_state()
    assert tree_err(got["params"], want["params"]) <= STATE_RTOL
    assert tree_err(got["target"], want["target"]) <= STATE_RTOL
    assert tree_err(got["opt_state"],
                    adam_state(want["opt_state"])) <= STATE_RTOL


# At one intra-op thread the conv case's parameters land 1.97e-5 from the
# reference's (the default pool: 9.7e-6). The gap is f32 summation order,
# not the update: the port alone moves a parameter by 2.3e-5 between one
# thread and eight, and with every tensor, batch and bias correction in
# f64 the two packages agree to ~6e-14 at one thread (this case).
F64_DQN = r"""
import sys
import types

import jax
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
torch.set_default_dtype(torch.float64)     # Adam's bias corrections too
torch.set_num_threads(1)
from ray_tpu import rllib as R
from ray_tpu.rllib import dqn as rdqn
from ray_tpu_torch import rllib as P
from ray_tpu_torch.rllib import dqn as pdqn
from rllib_parity import adam_state, tree_err

# Both learners cast their batches to np.float32: keep f64 there.
f64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                               if not k.startswith("__")})
f64.float32 = np.float64
rdqn.np = pdqn.np = f64


def up(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32
                        else np.asarray(a), tree)


kw = dict(obs_dim=42 * 42 * 4, obs_shape=(42, 42, 4), conv=True,
          hidden=(64,), num_actions=3)
ref = rdqn.DQNLearner(R.RLModuleSpec(
    **kw, module_cls=rdqn.EpsilonGreedyModule), seed=2)
port = pdqn.DQNLearner(P.RLModuleSpec(
    **kw, module_cls=pdqn.EpsilonGreedyModule), seed=2, device="cpu")
ref.set_state(up(ref.get_state()))
port.set_state(up(port.get_state()))
rng = np.random.default_rng(3)
for i in range(4):
    b = {"obs": rng.random((32, 42, 42, 4)),
         "rewards": rng.standard_normal(32),
         "next_obs": rng.random((32, 42, 42, 4)),
         "dones": (rng.random(32) < 0.1).astype(np.float64),
         "actions": rng.integers(0, 3, 32), "weights": rng.random(32)}
    ref.update(b)
    port.update(b)
    if i == 1:
        ref.sync_target()
        port.sync_target()
want, got = ref.get_state(), port.get_state()
assert jax.tree.leaves(got["params"])[0].dtype == np.float64
print("ERRS", tree_err(got["params"], want["params"]),
      tree_err(got["target"], want["target"]),
      tree_err(got["opt_state"], adam_state(want["opt_state"])))
"""


def test_dqn_conv_gap_is_f32_summation_order():
    """The conv DQN learners of ``test_dqn_learner_matches_reference``
    (4 weighted updates, a target sync after the second) at f64 in both
    packages, on one intra-op thread (in a subprocess: x64 is
    process-wide in JAX): parameters, target and Adam moments agree to
    1e-6, where at f32 one thread parts them by 1.97e-5."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), here,
                    os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", F64_DQN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    errs = [float(x) for x in out.stdout.split("ERRS")[1].split()]
    assert max(errs) <= 1e-6, errs


def _dqn(mod):
    cfg = (mod.DQNConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=2,
                        rollout_fragment_length=64)
           .rl_module(hidden=(32, 32))
           .training(num_steps_sampled_before_learning=128,
                     updates_per_iteration=4, target_update_freq=3,
                     train_batch_size=32)
           .debugging(seed=0))
    if mod is P:
        cfg.learners(device="cpu")
    return cfg.build()


def test_dqn_iteration_and_checkpoint(tmp_path):
    """One DQN iteration (epsilon-greedy sampling, prioritized replay, 4
    updates with a target sync) equal in sample and metrics; then a
    checkpoint round trip of the port."""
    ref, port = _dqn(R), _dqn(P)
    try:
        m_ref, m_port = ref.train(), port.train()
        assert np.array_equal(ref._replay._cols["obs"],
                              port._replay._cols["obs"])
        # priorities: |td| + 1e-6 from each learner's TD errors
        assert metric_err({"prio": port._replay._prio},
                          {"prio": ref._replay._prio}) <= METRIC_RTOL
        keys = ("qf_loss", "q_mean", "epsilon", "replay_size",
                "num_updates")
        assert metric_err({k: m_port[k] for k in keys},
                          {k: m_ref[k] for k in keys}) <= METRIC_RTOL
        want = ref._learner.get_state()
        got = port._learner.get_state()
        assert tree_err(got["params"], want["params"]) <= STATE_RTOL
        assert tree_err(got["target"], want["target"]) <= STATE_RTOL
        port.save_to_path(str(tmp_path))
        fresh = _dqn(P)
        fresh.restore_from_path(str(tmp_path))
        assert tree_err(fresh._learner.get_state(), got) == 0.0
        fresh.stop()
    finally:
        ref.stop()
        port.stop()


# ------------------------------------------------------------------ SAC
BOX = dict(obs_dim=3, num_actions=2, hidden=(32, 32), continuous=True,
           action_low=np.array([-2.0, -1.0], np.float32),
           action_high=np.array([2.0, 1.0], np.float32))


def _sac_pair(cql_weight, **kw):
    ref = rsac.SACLearner(R.RLModuleSpec(
        **BOX, module_cls=rsac.SquashedGaussianModule), seed=1,
        cql_weight=cql_weight, cql_num_actions=4, **kw)
    port = psac.SACLearner(P.RLModuleSpec(
        **BOX, module_cls=psac.SquashedGaussianModule), seed=1,
        cql_weight=cql_weight, cql_num_actions=4, device="cpu", **kw)
    return ref, port


def test_sac_draws_follow_the_reference_key_chain():
    """Each update splits the learner key, then k into k1, k2, k3: k1's
    normals for the next action, k3's uniforms in [-1, 1) and
    split(k2, cql_n)'s normals for CQL, and k2's normals again for the
    actor (sac.py:172-228) — every draw bit-equal to jax.random."""
    _, port = _sac_pair(5.0)
    key = jax.random.PRNGKey(1)
    B, A, n = 7, 2, 4
    for _ in range(2):
        key, k = jax.random.split(key)
        k1, k2, k3 = jax.random.split(k, 3)
        want = {"next": jax.random.normal(k1, (B, A)),
                "pi": jax.random.normal(k2, (B, A)),
                "cql_rand": jax.random.uniform(k3, (n, B, A), minval=-1.0,
                                               maxval=1.0),
                "cql_pi": jax.vmap(lambda kk: jax.random.normal(
                    kk, (B, A)))(jax.random.split(k2, n))}
        port._rng_key, pk = prng.split(port._rng_key)
        got = port.draws(pk, B)
        assert set(got) == set(want)
        for name in want:
            w = np.asarray(want[name])
            assert got[name].numpy().view(np.int32).tolist() == \
                w.view(np.int32).tolist(), name
    assert port._rng_key.numpy().tolist() == np.asarray(key).tolist()


@pytest.mark.parametrize("cql_weight", [0.0, 5.0])
def test_sac_learner_matches_reference(cql_weight):
    """Three SAC updates (and with CQL's regularizer), then the key chain,
    parameters, Polyak targets and Adam state."""
    ref, port = _sac_pair(cql_weight)
    rng = np.random.default_rng(4)
    for i in range(3):
        b = transitions(rng, 16, 3, 2, True)
        m_ref, m_port = ref.update(b), port.update(b)
        assert metric_err(m_port, m_ref) <= METRIC_RTOL, (i, m_ref, m_port)
    assert port._rng_key.numpy().tolist() == \
        np.asarray(ref._rng_key).tolist()
    want, got = ref.get_state(), port.get_state()
    assert tree_err(got["params"], want["params"]) <= STATE_RTOL
    assert tree_err(got["target_q"], want["target_q"]) <= STATE_RTOL
    assert tree_err(got["opt_state"],
                    adam_state(want["opt_state"])) <= STATE_RTOL
    w = port.get_weights()
    assert "log_alpha" not in w and "log_alpha" in port.params
    port.set_weights(w)
    assert float(port.params["log_alpha"]) == float(
        got["params"]["log_alpha"])


@pytest.mark.parametrize("algo", ["dqn", "sac"])
def test_update_full_is_update(algo):
    """``update_full`` is the reference's alias of ``update``
    (``ray_tpu/rllib/dqn.py:164``, ``sac.py:300``), with its signature:
    two learners from one seed, one updated through each, stay equal."""
    ref_cls, mod = (rdqn.DQNLearner, pdqn) if algo == "dqn" else \
        (rsac.SACLearner, psac)
    cls = mod.DQNLearner if algo == "dqn" else mod.SACLearner
    assert inspect.signature(cls.update_full) == \
        inspect.signature(ref_cls.update_full)
    if algo == "dqn":
        spec = dict(obs_dim=4, num_actions=3, hidden=(32, 32),
                    module_cls=pdqn.EpsilonGreedyModule)
    else:
        spec = dict(BOX, module_cls=psac.SquashedGaussianModule)
    a, b = (cls(P.RLModuleSpec(**spec), seed=2, device="cpu")
            for _ in range(2))
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = transitions(rng, 16, spec["obs_dim"], spec["num_actions"],
                            algo == "sac")
        m_a, m_b = a.update(batch), b.update_full(batch, unused=1)
        assert metric_err(m_b, m_a) == 0.0, (m_a, m_b)
    assert tree_err(b.get_state()["params"], a.get_state()["params"]) == 0


def test_squash_logp_is_logaddexp_softplus():
    """The torch path's softplus is logaddexp(x, 0) (jax.nn.softplus),
    not F.softplus, whose threshold switches to x past 20."""
    u = np.linspace(-30, 30, 61, dtype=np.float32)[:, None]
    ls = np.full_like(u, -0.5)
    mean = np.zeros_like(u)
    got = psac.squash_logp(*(torch.from_numpy(x) for x in (u, ls, mean)),
                           torch)
    want = rsac.squash_logp(*(jax.numpy.asarray(x) for x in (u, ls, mean)),
                            jax.numpy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    assert np.array_equal(psac.squash_logp(u, ls, mean, np),
                          rsac.squash_logp(u, ls, mean, np))


def _sac(mod):
    cfg = (mod.SACConfig().environment("Pendulum-v1")
           .env_runners(num_envs_per_env_runner=2,
                        rollout_fragment_length=32)
           .rl_module(hidden=(32, 32))
           .training(num_steps_sampled_before_learning=64,
                     updates_per_iteration=3, train_batch_size=32)
           .debugging(seed=0))
    if mod is P:
        cfg.learners(device="cpu")
    return cfg.build()


def test_sac_iteration_and_checkpoint(tmp_path):
    """One SAC iteration on Pendulum-v1: the sampled batch bit-equal (the
    squashed-Gaussian numpy rollout is copied), three updates within
    tolerance; then a checkpoint round trip of the port."""
    ref, port = _sac(R), _sac(P)
    try:
        seen = {}
        for name, algo in (("ref", ref), ("port", port)):
            sample = algo.env_runner_group.local.sample
            seen[name] = []

            def wrapped(sample=sample, out=seen[name]):
                out.append(sample())
                return out[-1]

            algo.env_runner_group.local.sample = wrapped
        m_ref, m_port = ref.train(), port.train()
        (b_ref,), (b_port,) = seen["ref"], seen["port"]
        for k in b_ref.cols:
            assert b_ref[k].dtype == b_port[k].dtype, k
            assert np.array_equal(b_ref[k], b_port[k]), k
        assert m_port["num_updates"] == 3
        keys = [k for k in m_ref if k not in ("episode_return_mean",
                                              "episode_return_max",
                                              "time_this_iter_s")]
        assert metric_err({k: m_port[k] for k in keys},
                          {k: m_ref[k] for k in keys}) <= METRIC_RTOL
        got = port._learner.get_state()
        assert tree_err(got["params"],
                        ref._learner.get_state()["params"]) <= STATE_RTOL
        port.save_to_path(str(tmp_path))
        fresh = _sac(P)
        fresh.restore_from_path(str(tmp_path))
        assert tree_err(fresh._learner.get_state(), got) == 0.0
        assert fresh.iteration == 1
        fresh.stop()
    finally:
        ref.stop()
        port.stop()


# ------------------------------------------------------------ offline
def _pendulum_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, 3)).astype(np.float32)
    act = np.clip(rng.standard_normal((n, 1)) * 0.5, -2, 2).astype(
        np.float32)
    return {"obs": obs, "actions": act,
            "rewards": -np.square(obs[:, :1] - act).sum(1).astype(
                np.float32),
            "next_obs": (obs + 0.1).astype(np.float32),
            "dones": (rng.random(n) < 0.02).astype(np.float32)}


def _cql(mod, data):
    cfg = (mod.CQLConfig()
           .offline(data, obs_dim=3, action_dim=1, action_low=[-2.0],
                    action_high=[2.0])
           .rl_module(hidden=(32, 32))
           .training(updates_per_iteration=3, train_batch_size=32,
                     cql_num_actions=4)
           .debugging(seed=0))
    if mod is P:
        cfg.learners(device="cpu")
    return mod.CQL(cfg)


def test_cql_matches_reference_and_checkpoints(tmp_path):
    data = _pendulum_rows(200)
    ref, port = _cql(R, data), _cql(P, data)
    m_ref, m_port = ref.train(), port.train()
    assert m_port["cql_loss"] > 0
    assert metric_err(m_port, m_ref) <= METRIC_RTOL
    want, got = ref.learner.get_state(), port.learner.get_state()
    assert tree_err(got["params"], want["params"]) <= STATE_RTOL
    assert tree_err(got["opt_state"],
                    adam_state(want["opt_state"])) <= STATE_RTOL
    obs = data["obs"][:5]
    np.testing.assert_allclose(port.compute_actions(obs),
                               ref.compute_actions(obs), atol=1e-5)
    port.save_to_path(str(tmp_path))
    fresh = _cql(P, data)
    fresh.restore_from_path(str(tmp_path))
    assert tree_err(fresh.learner.get_state(), got) == 0.0


def _offline_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, 4)).astype(np.float32)
    return [{"obs": o, "actions": int(o[0] + 0.3 * o[1] > 0),
             "rewards": float(r), "dones": float(d)}
            for o, r, d in zip(obs, rng.random(n),
                               rng.random(n) < 0.05)]


def _offline(mod, cls, data, **training):
    cfg = (getattr(mod, cls)().offline(data, obs_dim=4, num_actions=2)
           .rl_module(hidden=(32, 32))
           .training(minibatch_size=64, num_epochs=2, **training)
           .debugging(seed=0))
    if mod is P:
        cfg.learners(device="cpu")
    return cfg.algo_class(cfg)


@pytest.mark.parametrize("beta", [None, 0.0, 1.0])
def test_bc_and_marwil_match_reference(beta):
    """BC (``beta=None``) and MARWIL at beta 0 and 1: two iterations of
    two epochs; the parameters, Adam state, MARWIL's running ms_adv and
    the greedy actions."""
    rows = _offline_rows(300)
    if beta is None:
        ref, port = (_offline(m, "BCConfig", rows) for m in (R, P))
    else:
        ref, port = (_offline(m, "MARWILConfig", rows, beta=beta)
                     for m in (R, P))
    for _ in range(2):
        m_ref, m_port = ref.train(), port.train()
        assert metric_err(m_port, m_ref) <= METRIC_RTOL
    params = P.params_to_numpy(port.params)
    assert tree_err(params, ref.params) <= STATE_RTOL
    assert tree_err(P.params_to_numpy(port.opt_state),
                    adam_state(ref.opt_state)) <= STATE_RTOL
    if beta is not None:
        assert abs(float(port._ms_adv) - float(ref._ms_adv)) <= \
            METRIC_RTOL * max(1.0, abs(float(ref._ms_adv)))
        assert float(port._ms_adv) != 1.0
    obs = np.random.default_rng(1).standard_normal((50, 4)).astype(
        np.float32)
    assert np.array_equal(port.compute_actions(obs),
                          ref.compute_actions(obs))
