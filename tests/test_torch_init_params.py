"""The port draws the reference's random weights: ``init_params(cfg,
seed)`` is bit-equal to ``ray_tpu.models.gpt.init_params(PRNGKey(seed),
cfg)``, on the CPU, with no weights passed across.

Layer by layer: ``prng.normal`` equals ``jax.random.normal`` bit for bit;
underneath it ``erf_inv`` equals ``lax.erf_inv`` as XLA's CPU backend
computes it, through the port's copies of its f32 ``log1p``, its fused
multiply-adds (:func:`prng._fma`) and a correctly rounded square root
(:func:`prng._sqrt`: ``torch.sqrt`` on the CPU is not). Then the key
schedule: every leaf of ``init_params`` for three seeds, a one-layer
config (``split(key, 1)``, the drafter's trunk), ``tied_drafter_params``,
bfloat16 storage; and, end to end, seeded ``spec_decode="model"``
streams at temperature 0.8 equal to the reference engine's when each
package builds its own target and drafter from the same seed.

The bound is exact equality (0 ulps) everywhere.
"""
import dataclasses
import threading
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import draft as jdraft
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch._private import prng
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import draft as tdraft
from ray_tpu_torch.serve.engine import DecodeEngine

NANO = jgpt.CONFIGS["nano"]
TNANO = tgpt.CONFIGS["nano"]
SEEDS = (0, 1, 2 ** 31 - 1)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def key(seed: int) -> torch.Tensor:
    return torch.from_numpy(prng.PRNGKey(seed).astype(np.int64))


def port_tree(jax_params) -> dict:
    return tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def assert_bit_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert torch.equal(got[name].view(torch.int32)
                           if got[name].dtype == torch.float32
                           else got[name].view(torch.int16),
                           want[name].view(torch.int32)
                           if want[name].dtype == torch.float32
                           else want[name].view(torch.int16)), name


# ------------------------------------------------------------ the draw
def test_erf_inv_equals_xla():
    """A million uniform points in (-1, 1), both ends, zero and tiny
    values: the same bits as ``lax.erf_inv``, both branches (w < 5 and
    w >= 5) included."""
    rng = np.random.default_rng(0)
    u = np.concatenate([
        rng.uniform(-1, 1, 1_000_000).astype(np.float32),
        np.float32(1) - rng.uniform(0, 1e-3, 20_000).astype(np.float32),
        np.array([-0.99999994, 0.99999994, 0.0, 1e-30, -1e-20, 0.5, 1.0,
                  -1.0], np.float32)])
    want = np.asarray(jax.jit(lax.erf_inv)(u))
    got = prng.erf_inv(torch.from_numpy(u)).numpy()
    inner = u[np.abs(u) < 1].astype(np.float64)
    assert (-np.log1p(-inner ** 2) >= 5).sum() > 1000   # sqrt branch
    np.testing.assert_array_equal(bits(got), bits(want))


def test_log1p_equals_xla_on_the_draws_domain():
    """``erf_inv`` calls ``log1p(-u * u)``: arguments in (-1, 0]."""
    rng = np.random.default_rng(1)
    u = rng.uniform(-1, 1, 500_000).astype(np.float32)
    a = u * -u
    want = np.asarray(jax.jit(lax.log1p)(a))
    np.testing.assert_array_equal(
        bits(prng._log1p(torch.from_numpy(a)).numpy()), bits(want))


def test_fma_rounds_once():
    """``_fma`` is the correctly rounded ``a * b + c``: held against
    exact rational arithmetic on random operands and on sums that land
    near float32 ties."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 1e-3).astype(np.float32)
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    got = prng._fma(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        f = np.float32(float(exact))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(bits(v)) & 1))
        assert bits(g) == bits(best), (x, y, z)


def test_sqrt_correctly_rounded():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 10, 300_000),
                        rng.uniform(0, 1e-30, 1000)]).astype(np.float32)
    np.testing.assert_array_equal(
        bits(prng._sqrt(torch.from_numpy(x)).numpy()), bits(np.sqrt(x)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (256, 300)])
def test_normal_equals_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(key(seed), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


def test_normal_lanes_are_per_layer_draws():
    """``normal`` of ``[L, 2]`` keys draws one block per key, as one
    ``jax.random.normal`` per layer key does."""
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.stack([np.asarray(jax.random.normal(k, (4, 6))) for k in ks])
    got = prng.normal(prng.split(key(5), 3), (4, 6)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


# ------------------------------------------------------- init_params
@pytest.mark.parametrize("seed", SEEDS)
def test_init_params_bit_equal(seed):
    want = port_tree(jgpt.init_params(jax.random.PRNGKey(seed), NANO))
    assert_bit_equal(tgpt.init_params(TNANO, seed, device="cpu"), want)


@pytest.mark.parametrize("n_layer", [1, 3])
def test_init_params_key_schedule_other_depths(n_layer):
    """``split(key, L)`` for L = 1 (the drafter's trunk) and 3, at other
    widths (vocab 1024, d_model 96, d_ff 160)."""
    kw = dict(n_layer=n_layer, vocab_size=1024, d_model=96, d_ff=160,
              n_head=3)
    want = port_tree(jgpt.init_params(jax.random.PRNGKey(11),
                                      dataclasses.replace(NANO, **kw)))
    got = tgpt.init_params(dataclasses.replace(TNANO, **kw), 11,
                           device="cpu")
    assert_bit_equal(got, want)


def test_init_params_bf16_storage():
    """Storage in bfloat16 is each float32 draw rounded once, as the
    reference's ``astype(param_dtype)``."""
    jcfg = dataclasses.replace(NANO, param_dtype=jnp.bfloat16)
    want = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jgpt.init_params(jax.random.PRNGKey(2), jcfg))
    got = tgpt.init_params(TNANO, 2, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    assert_bit_equal({k: v.float() for k, v in got.items()},
                     tgpt.params_from_numpy(want, "cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_tied_drafter_params_equal_reference(seed):
    jp = jgpt.init_params(jax.random.PRNGKey(0), NANO)
    jdp, jdcfg = jdraft.tied_drafter_params(jp, NANO, seed=seed)
    tp = tgpt.init_params(TNANO, 0, device="cpu")
    tdp, tdcfg = tdraft.tied_drafter_params(tp, TNANO, seed=seed)
    assert tdcfg.n_layer == jdcfg.n_layer == 1
    assert tdp["embed"] is tp["embed"]
    assert tdp["pos_embed"] is tp["pos_embed"]
    assert_bit_equal(tdp, port_tree(jdp))


# ------------------------------------------------------- end to end
J32 = dataclasses.replace(NANO, dtype=jnp.float32)
T32 = dataclasses.replace(TNANO, dtype=torch.float32)


def _drain(eng, prompts, max_news, seeds):
    outs = {}

    def consume(i):
        outs[i] = np.concatenate(list(eng.stream(
            prompts[i], max_news[i], seed=seeds[i])))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    return [outs[i] for i in range(len(prompts))]


@pytest.mark.parametrize("paged", [True, False])
def test_model_drafter_streams_without_weights_passed(paged):
    """``spec_decode="model"`` at temperature 0.8: each package builds
    its target from ``seed`` 3 and its drafter itself; the streams are
    the reference engine's token for token, acceptance pattern and PRNG
    chain included."""
    jp = jgpt.init_params(jax.random.PRNGKey(3), J32)
    tp = tgpt.init_params(T32, 3, device="cpu")
    kw = dict(slots=3, chunk=4, max_len=64, prompt_buckets=(8, 16),
              temperature=0.8, spec_decode="model", draft_k=4)
    rng = np.random.default_rng(40)
    prompts = [np.full((9,), 7, np.int32)] + [
        rng.integers(0, NANO.vocab_size, (n,)).astype(np.int32)
        for n in (5, 13)]
    max_news, seeds = [16, 12, 14], [4, 5, 2 ** 31 - 1]
    ref = JaxEngine(jp, J32, paged=paged, page_size=8, **kw)
    eng = DecodeEngine(tp, T32, paged=paged, page_size=8, device="cpu",
                       **kw)
    try:
        # The reference drafter's cursor may alias its numpy buffer on
        # the CPU (tests/test_torch_spec.py::unaliased_pos).
        ref._drafter._pos = np.zeros(2 * ref._drafter.slots,
                                     np.int32)[::2]
        want = _drain(ref, prompts, max_news, seeds)
        got = _drain(eng, prompts, max_news, seeds)
        st = eng.stats()["spec"]
    finally:
        ref.shutdown()
        eng.shutdown()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")
    assert st["drafter"] == "model" and st["rounds"] > 0
