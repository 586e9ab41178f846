"""The port's flat KV pools (``ray_tpu_torch.models.gpt_decode``:
``init_cache``/``prefill``/``decode_step``/``decode_chunk``/``generate``/
``generate_chunked`` and the slot pool ``init_slot_cache``/
``prefill_into_slot``/``decode_chunk_slots``) against the JAX reference
on the same nano weights at an f32 compute dtype, on the CPU.

Logits agree within ``atol=1e-5`` (the same f32 arithmetic up to
summation order); tokens, at temperature 0 and seeded 0.8, and the
returned PRNG lanes must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu_torch._private import prng
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import gpt_decode as tgd
from torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 48


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jgpt.CONFIGS["nano"])
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, tcfg, jp, tp


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def test_prefill_and_decode_step_logits(setup):
    jcfg, tcfg, jp, tp = setup
    prompt = _prompt(0, (3, 11), tcfg.vocab_size)
    jc = jgd.init_cache(jcfg, 3, MAX_LEN)
    tc = tgd.init_cache(tcfg, 3, MAX_LEN, "cpu")
    jl, jc = jgd.prefill(jp, jnp.asarray(prompt), jcfg, jc)
    tl = tgd.prefill(tp, prompt, tcfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    assert int(tc["pos"]) == 11
    for step in range(3):
        token = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jgd.decode_step(jp, jc, jnp.asarray(token), jcfg)
        tl = tgd.decode_step(tp, tc, token, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5, err_msg=f"step {step}")
    assert int(tc["pos"]) == int(jc["pos"]) == 14
    np.testing.assert_allclose(tc["k"][:, :, :14].numpy(),
                               np.asarray(jc["k"])[:, :, :14], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3),
                                              (0.8, 2 ** 31 - 1)])
def test_generate_token_identical(setup, temperature, seed):
    jcfg, tcfg, jp, tp = setup
    prompt = _prompt(1, (2, 7), tcfg.vocab_size)
    kw = dict(max_len=MAX_LEN, temperature=temperature)
    ref = np.stack([np.asarray(t) for t in jgd.generate(
        jp, jnp.asarray(prompt), jcfg, 12,
        rng=jax.random.PRNGKey(seed), **kw)], 1)
    got = np.stack(list(tgd.generate(tp, prompt, tcfg, 12,
                                     rng=prng.PRNGKey(seed), device="cpu",
                                     **kw)), 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("temperature,seed,eos", [
    (0.0, 0, -1), (0.8, 3, -1), (0.8, 11, "mid")])
def test_generate_chunked_token_identical(setup, temperature, seed, eos):
    """Chunks of 4 over 17 tokens; with ``eos`` set to a token the
    stream emits mid-way, both sides cut at the same place."""
    jcfg, tcfg, jp, tp = setup
    prompt = _prompt(2, (3, 9), tcfg.vocab_size)

    def run(eos_token):
        kw = dict(chunk=4, max_len=MAX_LEN, temperature=temperature,
                  eos_token=eos_token)
        ref = list(jgd.generate_chunked(jp, jnp.asarray(prompt), jcfg, 17,
                                        rng=jax.random.PRNGKey(seed), **kw))
        got = list(tgd.generate_chunked(tp, prompt, tcfg, 17,
                                        rng=prng.PRNGKey(seed),
                                        device="cpu", **kw))
        return ref, got

    ref, got = run(-1)
    if eos == "mid":
        eos_token = int(np.concatenate(ref, 1)[0, 6])
        ref, got = run(eos_token)
    assert [g.shape for g in got] == [r.shape for r in ref]
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(ref, 1))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_slot_pool_token_and_lane_identical(setup, temperature):
    """Three prompts of other lengths in slots 0, 2, 3 of a 4-slot pool
    (slot 1 empty), each with its own seeded lane; two 4-step chunks with
    an EOS token taken from slot 2's first chunk, so that lane
    mask-and-carries. Tokens, ``done``, ``pos`` and the returned lanes
    must all be identical."""
    jcfg, tcfg, jp, tp = setup
    slots, bucket = 4, 16
    jc = jgd.init_slot_cache(jcfg, slots, MAX_LEN)
    tc = tgd.init_slot_cache(tcfg, slots, MAX_LEN, "cpu")
    rngs = np.zeros((slots, 2), np.uint32)
    token = np.zeros((slots,), np.int32)
    for slot, (n, seed) in zip([0, 2, 3], [(5, 7), (13, 8), (16, 2 ** 40)]):
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = _prompt(slot, (n,), tcfg.vocab_size)
        jt, jc, jk = jgd.prefill_into_slot(
            jp, jc, jnp.asarray(padded), jnp.int32(n), jnp.int32(slot),
            jax.random.PRNGKey(seed), cfg=jcfg, temperature=temperature)
        tt, tk = tgd.prefill_into_slot(tp, tc, padded, n, slot,
                                       prng.PRNGKey(seed), cfg=tcfg,
                                       temperature=temperature)
        assert tt == int(jt)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        token[slot], rngs[slot] = tt, tk
    np.testing.assert_array_equal(tc["pos"].numpy(), [5, 0, 13, 16])
    active = np.array([True, False, True, True])

    def both(token, rngs, jc, eos_token):
        jt, jc, jd, jr = jgd.decode_chunk_slots(
            jp, jc, jnp.asarray(token), jnp.asarray(rngs),
            jnp.asarray(active), cfg=jcfg, k=4, temperature=temperature,
            eos_token=eos_token)
        tt, td, tr = tgd.decode_chunk_slots(
            tp, tc, token, rngs, active, cfg=tcfg, k=4,
            temperature=temperature, eos_token=eos_token)
        np.testing.assert_array_equal(tt[active], np.asarray(jt)[active])
        np.testing.assert_array_equal(td[active], np.asarray(jd)[active])
        np.testing.assert_array_equal(tr[active], np.asarray(jr)[active])
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        return tt, td, tr, jc

    # A first run picks slot 2's second token as EOS; then the same
    # chunk reruns from the same state (the reference's pool is
    # immutable, the port's is restored from a copy).
    tc0 = {k: v.clone() for k, v in tc.items()}
    tt, _, _, _ = both(token, rngs, jc, -1)
    eos = int(tt[2, 1])
    tc.update(tc0)
    tt, td, tr, jc = both(token, rngs, jc, eos)
    assert td[2] and (tt[2, 1:] == eos).all()
    tt, td, tr, jc = both(tt[:, -1].copy(), tr, jc, eos)
    assert (tt[2] == eos).all()


def test_flat_entry_points_default_to_the_card(setup):
    """Without ``device``, the flat entry points resolve to ``cuda`` and
    raise without a card; with ``device="cpu"`` they run."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    _jcfg, tcfg, _jp, tp = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgd.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgd.init_slot_cache(tcfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tgd.generate_chunked(tp, np.zeros((1, 3), np.int32), tcfg, 2))
