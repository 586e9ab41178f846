"""The port's DreamerV3 (``ray_tpu_torch.rllib.dreamerv3``) against the JAX
reference on the CPU.

Bit-equal: the twohot bins (JAX's float32 ``linspace``), the twohot
code, ``init_dreamer_params``, ``SequenceReplay`` samples, the learner's
key chain, and the draws along it: ``jax.random.categorical`` (which is
``argmax(gumbel + logits)``) index for index and ``jax.random.normal``
bit for bit. ``symlog`` and ``symexp`` are within ``SYM_ULPS`` (the two
frameworks' ``log1p`` and ``exp``). Updates are held as the other learners' are
(``rllib_parity.py``): every metric, parameter, Adam moment and slow
critic leaf within 1e-5, each update from the reference's state, except
a parameter whose Adam step sits at the optimiser's epsilon
(``ADAM_EPS_SCALE``), held within the learning rate.

The updates start from ``init_dreamer_params`` with the last layers of
the reward and critic heads drawn from a seed (both packages get the
same numpy weights). At the reference's own init those two layers are
zero, so every imagined reward and value is ``softmax(0) @ bins``: the
rounding noise of a 255-term sum of ±20 (~1e-7), and so are the
returns and advantages that drive the actor. Two f32 implementations
sum in different orders; Adam turns each actor gradient's sign into a
±lr step, so from that init the actor's leaves part by up to 0.28 of
their size after one update in any two such implementations, while the
metrics agree (``test_update_from_the_reference_init_holds_metrics``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import dreamerv3 as rd
from ray_tpu_torch._private import prng
from ray_tpu_torch.rllib import dreamerv3 as pd
from ray_tpu_torch.rllib.rl_module import params_to_torch
from rllib_parity import METRIC_RTOL, STATE_RTOL, adam_state, metric_err, \
    tree_err
from test_rllib_dreamer import _CounterEnv, _Drive1D
from torch_threads import one_torch_thread  # noqa: F401

#: symlog/symexp: units in the last place between the packages.
SYM_ULPS = 2
#: Adam divides a step by ``sqrt(nu_hat) + 1e-8``. Where ``sqrt(nu_hat)``
#: is below this, the gradient element is within 100x of that epsilon, so
#: the step's size turns on the element's last bits (a sum that cancels
#: to ~1e-8 differs by ~1e-3 of itself between two summation orders):
#: such a parameter may part from the reference's by more than
#: STATE_RTOL, never by more than the learning rate.
ADAM_EPS_SCALE = 1e-6


def _config(mod, size, env=_CounterEnv):
    cfg = mod.DreamerV3Config().environment(env_creator=env)
    if size == "tiny":   # tests/test_rllib_dreamer.py:58-73
        cfg.deter_dim = 32
        cfg.units = 32
        cfg.stoch_dims = 4
        cfg.stoch_classes = 4
        cfg.horizon = 5
        cfg.seq_len = 8
        cfg.batch_seqs = 4
        cfg.lr = 3e-4
        cfg.rollout_fragment_length = 32
        cfg.num_steps_before_learning = 32
        cfg.updates_per_iteration = 4
    if env is _Drive1D:
        cfg.experimental_continuous = True
    if mod is pd:
        cfg.learners(device="cpu")
    return cfg


def _batch(rng, cfg, spec):
    B, L = cfg.batch_seqs, cfg.seq_len
    if spec.continuous:
        a_prev = rng.uniform(-1, 1, (B, L, spec.num_actions)).astype(
            np.float32)
    else:
        a_prev = rng.integers(0, spec.num_actions, (B, L))
    return {"obs": rng.standard_normal((B, L, spec.obs_dim)).astype(
                np.float32),
            "a_prev": a_prev,
            "rewards": (rng.random((B, L)) < 0.3).astype(np.float32),
            "terms": (rng.random((B, L)) < 0.05).astype(np.float32),
            "is_first": (rng.random((B, L)) < 0.1).astype(np.float32)}


def _weights(spec, cfg, seed, live_heads=True):
    w = rd.init_dreamer_params(spec, cfg, seed)
    if live_heads:
        rng = np.random.default_rng(seed + 100)
        for head in ("reward", "critic"):
            last = w[head][-1]["w"]
            w[head][-1]["w"] = (0.3 * rng.standard_normal(last.shape)
                                ).astype(np.float32)
    return w


class _Pair:
    """One reference learner (its jitted step reused, pure) and one port
    learner, stepped from the same state along the same key chain."""

    def __init__(self, size, env=_CounterEnv, seed=0):
        self.rcfg, self.pcfg = _config(rd, size, env), _config(pd, size, env)
        self.rspec, self.pspec = (self.rcfg.module_spec(),
                                  self.pcfg.module_spec())
        self.ref = rd.DreamerV3Learner(self.rspec, self.rcfg, seed=seed)
        self.seed = seed

    def start(self, live_heads=True):
        w = _weights(self.rspec, self.rcfg, self.seed, live_heads)
        self.params, self.slow = w, [dict(l) for l in w["critic"]]
        self.opt = self.ref._opt.init(w)
        self.key = jax.random.PRNGKey(self.seed)
        self.port = pd.DreamerV3Learner(self.pspec, self.pcfg,
                                        seed=self.seed, device="cpu")
        self.port.set_weights(w)
        self.port._slow_critic = params_to_torch(w["critic"], "cpu")

    def sync(self):
        """Give the port the reference's state (its key chain runs on)."""
        self.port.set_state({"params": self.params, "slow": self.slow,
                             "opt": adam_state(self.opt)})

    def step(self, batch):
        self.key, k = jax.random.split(self.key)
        self.params, self.slow, self.opt, m = self.ref._train_step(
            self.params, self.slow, self.opt, k, batch)
        want = {name: float(v) for name, v in m.items()}
        return self.port.update(batch), want

    def state_errs(self):
        """``(params, slow, opt)``: the slow critic's and Adam moments'
        largest leaf errors; the parameters' largest outside the elements
        ADAM_EPS_SCALE excuses (those are held within the learning
        rate)."""
        got = self.port.get_state()
        opt = adam_state(self.opt)
        bias = 1 - 0.999 ** int(opt["count"])
        worst = 0.0
        for a, b, nu in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(self.params),
                            jax.tree.leaves(opt["nu"])):
            a, b = a.astype(np.float64), np.asarray(b)
            diff = np.abs(a - b)
            rel = diff / max(float(np.abs(b).max()), 1e-3)
            eps_scale = np.sqrt(np.asarray(nu) / bias) < ADAM_EPS_SCALE
            assert (diff[eps_scale] <= self.rcfg.lr).all()
            worst = max(worst, float(np.where(eps_scale, 0.0, rel).max()))
        return (worst, tree_err(got["slow"], self.slow),
                tree_err(got["opt"], opt))


@pytest.fixture(scope="module")
def tiny():
    return _Pair("tiny")


# ------------------------------------------------------------------ math
def test_bins_are_jnp_linspace():
    """The torch bins are ``jnp.linspace(-20, 20, 255)`` bit for bit (not
    ``torch.linspace`` nor ``np.linspace`` in float32); the numpy bins
    stay the reference's float64 ``np.linspace``."""
    want = np.asarray(jnp.linspace(-20.0, 20.0, 255))
    got = pd._bins(torch).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.linspace(-20.0, 20.0, 255).numpy() != want).sum() > 100
    assert np.array_equal(pd._bins(np), rd._bins(np))


def test_twohot_symlog_symexp_match_reference():
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.standard_normal(500) * 5,
                        [-25.0, 25.0, -20.0, 20.0, 0.0, 0.1]]).astype(
        np.float32)
    want = np.asarray(rd.twohot(jnp.asarray(y), jnp))
    got = pd.twohot(torch.from_numpy(y), torch).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(pd.twohot(y), rd.twohot(y))
    # symlog within SYM_ULPS of its value; symexp's ``exp(|y|) - 1``
    # cancels near 0, so within SYM_ULPS ulps of ``exp(|y|)``
    scale = {"symlog": np.asarray(rd.symlog(y)),
             "symexp": np.exp(np.abs(y))}
    for name in ("symlog", "symexp"):
        want = np.asarray(getattr(rd, name)(jnp.asarray(y), jnp))
        got = getattr(pd, name)(torch.from_numpy(y), torch).numpy()
        ulps = np.abs(got - want) / np.spacing(np.abs(scale[name]))
        assert ulps.max() <= SYM_ULPS, (name, ulps.max())
        assert np.array_equal(getattr(pd, name)(y), getattr(rd, name)(y))
    logits = rng.standard_normal((64, pd.NUM_BINS)).astype(np.float32)
    assert np.array_equal(pd.twohot_mean(logits), rd.twohot_mean(logits))


@pytest.mark.parametrize("env", [_CounterEnv, _Drive1D],
                         ids=["discrete", "continuous"])
def test_init_dreamer_params_bit_equal(env):
    rcfg, pcfg = _config(rd, "tiny", env), _config(pd, "tiny", env)
    got = pd.init_dreamer_params(pcfg.module_spec(), pcfg, 7)
    want = rd.init_dreamer_params(rcfg.module_spec(), rcfg, 7)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def test_sequence_replay_sample_equal():
    rng = np.random.default_rng(1)
    replays = [m.SequenceReplay(3, 8, seed=2) for m in (rd, pd)]
    for n in (12, 5, 20, 9, 16):     # a short one is dropped; capacity 3
        frag = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                "a_prev": rng.integers(0, 2, n),
                "rewards": rng.random(n).astype(np.float32),
                "terms": (rng.random(n) < 0.1).astype(np.float32),
                "is_first": (rng.random(n) < 0.2).astype(np.float32)}
        for r in replays:
            r.add_fragment(frag)
    assert len(replays[0]) == len(replays[1]) == 3
    for _ in range(3):
        want, got = replays[0].sample(5), replays[1].sample(5)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_key_chain_and_draws_bit_equal(continuous):
    """An update's keys (k1, k2, ``split(k1, L)``, ``split(k2, H)`` and
    each step's (ka, kz)) bit-equal to ``jax.random``'s, and the draws
    along them: posterior and imagined latents and discrete actions
    through ``categorical`` index for index, continuous actions'
    ``normal`` bit for bit, the Gumbel noise itself within
    ``test_torch_prng.py``'s ulp bound."""
    env = _Drive1D if continuous else _CounterEnv
    cfg = _config(pd, "tiny", env)
    spec = cfg.module_spec()
    learner = pd.DreamerV3Learner(spec, cfg, seed=3, device="cpu")
    B, L, H = cfg.batch_seqs, cfg.seq_len, cfg.horizon
    S, C, N, A = cfg.stoch_dims, cfg.stoch_classes, B * cfg.seq_len, \
        spec.num_actions
    jkey, k = jax.random.split(jax.random.PRNGKey(3))
    key, pk = prng.split(learner._key)
    assert np.array_equal(key.numpy(), np.asarray(jkey))
    got = learner.draws(pk, B, L)
    k1, k2 = jax.random.split(k)
    obs_keys, img_keys = jax.random.split(k1, L), jax.random.split(k2, H)
    for name, want in (("k1", k1), ("k2", k2), ("obs_keys", obs_keys),
                       ("img_keys", img_keys)):
        assert np.array_equal(got[name].numpy(), np.asarray(want)), name
    rng = np.random.default_rng(0)

    def as_bits(x):
        return np.asarray(x).view(np.int32)

    def assert_gumbel(noise, key):
        # tests/test_torch_prng.py::test_gumbel_within_ulp's bound: the
        # uniform bits are equal, XLA's log may round an ulp apart
        want = np.asarray(jax.random.gumbel(key, noise.shape))
        bound = 4 * (np.spacing(np.abs(want)) + 2.0 ** -23)
        assert (np.abs(noise.numpy() - want) <= bound).all()

    for t in range(L):
        assert_gumbel(got["obs"][t], obs_keys[t])
        lg = rng.standard_normal((B, S, C)).astype(np.float32)
        assert np.array_equal(
            torch.argmax(got["obs"][t] + torch.from_numpy(lg), -1).numpy(),
            np.asarray(jax.random.categorical(obs_keys[t], lg, -1)))
    for t in range(H):
        ka, kz = jax.random.split(img_keys[t])
        assert np.array_equal(got["ka"][t].numpy(), np.asarray(ka))
        assert np.array_equal(got["kz"][t].numpy(), np.asarray(kz))
        assert_gumbel(got["z"][t], kz)
        lz = rng.standard_normal((N, S, C)).astype(np.float32)
        assert np.array_equal(
            torch.argmax(got["z"][t] + torch.from_numpy(lz), -1).numpy(),
            np.asarray(jax.random.categorical(kz, lz, -1)))
        if continuous:
            assert np.array_equal(as_bits(got["act"][t].numpy()), as_bits(
                jax.random.normal(ka, (N, A))))
        else:
            assert_gumbel(got["act"][t], ka)
            la = rng.standard_normal((N, A)).astype(np.float32)
            assert np.array_equal(
                torch.argmax(got["act"][t] + torch.from_numpy(la),
                             -1).numpy(),
                np.asarray(jax.random.categorical(ka, la, -1)))


# ---------------------------------------------------------------- updates
def _hold(pair, batches):
    """Each update from the reference's state (so each comparison is one
    update's arithmetic), along the learner's own key chain."""
    for i, batch in enumerate(batches):
        pair.sync()
        got, want = pair.step(batch)
        assert metric_err(got, want) <= METRIC_RTOL, (i, got, want)
        params, slow, opt = pair.state_errs()
        assert max(params, slow, opt) <= STATE_RTOL, (i, params, slow, opt)
    assert np.array_equal(pair.port._key.numpy(), np.asarray(pair.key))


def test_update_matches_reference_tiny(tiny):
    """The reference tests' tiny config: ``wm_only`` (the world-model
    loss alone), then one update and two more chained on it (three in
    all: the key chain, Adam's count and the slow critic carried), each
    one's metrics and state within 1e-5, the key chains equal."""
    tiny.start()
    rng = np.random.default_rng(5)
    batch, key = _batch(rng, tiny.rcfg, tiny.rspec), jax.random.PRNGKey(9)
    want_loss, want = tiny.ref.wm_only(tiny.params, key, batch)
    got_loss, got = tiny.port.wm_only(tiny.port.params, np.asarray(key),
                                      batch)
    want["loss"], got["loss"] = want_loss, got_loss
    assert metric_err({k: float(v) for k, v in got.items()},
                      {k: float(v) for k, v in want.items()}) <= METRIC_RTOL
    _hold(tiny, [_batch(rng, tiny.rcfg, tiny.rspec) for _ in range(3)])
    draws = tiny.port.last_draws
    B, L, H = tiny.rcfg.batch_seqs, tiny.rcfg.seq_len, tiny.rcfg.horizon
    assert draws["observe"].shape == (L, B, tiny.rcfg.stoch_dims)
    assert draws["imagine_z"].shape == (H, B * L, tiny.rcfg.stoch_dims)
    assert draws["actions"].shape == (H, B * L)


def test_update_from_the_reference_init_holds_metrics(tiny):
    """From the reference's own init (zero reward and critic last
    layers) one update's metrics agree; the actor's step there is
    rounding noise (see the module docstring), and the world model's
    leaves agree."""
    tiny.start(live_heads=False)
    got, want = tiny.step(_batch(np.random.default_rng(6), tiny.rcfg,
                                 tiny.rspec))
    assert metric_err(got, want) <= METRIC_RTOL
    state = tiny.port.get_state()["params"]
    for part in ("encoder", "gru", "prior", "posterior", "decoder", "cont"):
        assert tree_err(state[part], tiny.params[part]) <= STATE_RTOL, part


def test_update_matches_reference_xs():
    """The reference's XS size (the default config: deter 256, units
    256, 8x8 latents, horizon 15, seq_len 16, 8 sequences)."""
    pair = _Pair("xs", seed=1)
    pair.start()
    _hold(pair, [_batch(np.random.default_rng(7), pair.rcfg, pair.rspec)])


def test_continuous_update_matches_reference():
    """The experimental continuous branch: tanh-Gaussian actor,
    REINFORCE on the stopped sample, the entropy through it."""
    pair = _Pair("tiny", env=_Drive1D, seed=2)
    pair.start()
    rng = np.random.default_rng(8)
    _hold(pair, [_batch(rng, pair.rcfg, pair.rspec) for _ in range(2)])


def test_learner_needs_a_card_unless_told():
    cfg = _config(pd, "tiny")
    cfg.device = None
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.DreamerV3Learner(cfg.module_spec(), cfg)


# ------------------------------------------------------------- algorithm
def test_dreamer_e2e_and_checkpoint(tmp_path):
    """Three iterations of the port's loop (sample → arrival stream →
    replay → updates → sync): the first iteration's replay is the
    reference's, bit for bit (the reference's iteration samples and
    converts only: its updates, which the tests above hold, would
    compile its whole step again); metrics are finite, the runner holds
    the learner's weights, and the state round-trips through
    save/restore."""
    rcfg = _config(rd, "tiny")
    rcfg.num_steps_before_learning = 10 ** 9
    ref = rcfg.build()
    algo = _config(pd, "tiny").build()
    try:
        ref.train()
        m = algo.train()
        assert len(algo._replay) == len(ref._replay) >= 1
        for got, want in zip(algo._replay._frags, ref._replay._frags):
            for k in want:
                assert np.array_equal(got[k], want[k]), k
        for _ in range(2):
            m = algo.train()
        assert m["num_updates"] == 12
        assert np.isfinite(m["loss"]) and np.isfinite(m["ac/entropy"])
        runner = algo.env_runner_group.local.module.params
        assert tree_err(runner, algo.learner_group.get_weights()) == 0.0
        path = algo.save_to_path(str(tmp_path / "ckpt"))
        saved = algo.learner_group.get_state()
        algo.train()
        algo.restore_from_path(path)
        assert tree_err(algo.learner_group.get_state(), saved) == 0.0
    finally:
        ref.stop()
        algo.stop()


def test_continuous_public_config_rejects_box_actions():
    cfg = pd.DreamerV3Config().environment(env_creator=_Drive1D)
    cfg.deter_dim = 32
    cfg.units = 32
    cfg.learners(device="cpu")
    with pytest.raises(ValueError, match="EXPERIMENTAL"):
        cfg.build()


def test_num_learners_refused():
    cfg = _config(pd, "tiny").learners(num_learners=2)
    with pytest.raises(ValueError, match="single"):
        cfg.build()
