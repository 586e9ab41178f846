"""The port's paged prefill and k-step decode
(``ray_tpu_torch.models.gpt_decode``) against the JAX reference's
(``ray_tpu.models.gpt_decode``) on the same nano weights at an f32
compute dtype, for fp and int8 pools.

One scenario drives both packages through the same page tables:

- slot 0: a fresh 13-token prompt (pages 3, 5);
- slot 1: a page-aligned prefix hit on slot 0's first page (history 8,
  suffix 6, fresh page 7);
- slot 2: slot 0's whole prompt plus 4 tokens — the prefix ends mid-page,
  so page 5 is forked copy-on-write into page 9 (pages 3, 9, 10);
- slot 3 stays empty (an all-sentinel row, inactive in decode);

then one 4-step decode chunk over the pool, with the pages the chunk
needs mapped first. Compared: first tokens and decoded tokens (exactly),
``pos`` (exactly), and the pool at every held position.
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

PS, SLOTS, N_PAGES, MAX_PAGES, K = 8, 4, 16, 8, 4
SENT = tgd.PT_SENTINEL
KEY = prng.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jgpt.CONFIGS["nano"])
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, tcfg, jp, tp


def _row(pages):
    row = np.full((MAX_PAGES,), SENT, np.int32)
    row[:len(pages)] = pages
    return row


def _admissions(vocab):
    """(slot, prompt suffix, true length, hist_len, page row, cow_src,
    bucket) for the three prefills, plus the full prompts."""
    rng = np.random.default_rng(7)
    p0 = rng.integers(0, vocab, (13,)).astype(np.int32)
    p1 = np.concatenate([p0[:8], rng.integers(0, vocab, (6,))]
                        ).astype(np.int32)
    p2 = np.concatenate([p0, rng.integers(0, vocab, (4,))]).astype(np.int32)
    return [
        (0, p0, 13, 0, _row([3, 5]), SENT, 16),
        (1, p1[8:], 6, 8, _row([3, 7]), SENT, 8),
        (2, p2[13:], 4, 13, _row([3, 9, 10]), 5, 8),
    ], [p0, p1, p2]


def _pad(suffix, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(suffix)] = suffix
    return out


@pytest.mark.parametrize("attn_kernel", ["gather", "cuda"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_prefill_and_decode_match_jax(setup, kv_dtype, attn_kernel):
    _run_scenario(setup, kv_dtype, attn_kernel, 0.0)


@pytest.mark.parametrize("attn_kernel", ["gather", "cuda"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_seeded_sampling_matches_jax(setup, kv_dtype, attn_kernel):
    """The same scenario at temperature 0.8 with a seeded PRNG lane per
    slot: first tokens, chunk tokens and the returned lanes identical."""
    _run_scenario(setup, kv_dtype, attn_kernel, 0.8)


def _run_scenario(setup, kv_dtype, attn_kernel, temperature):
    jcfg, tcfg, jp, tp = setup
    jc = jgd.init_paged_cache(jcfg, SLOTS, N_PAGES, PS, kv_dtype)
    tc = tgd.init_paged_cache(tcfg, SLOTS, N_PAGES, PS, kv_dtype, "cpu")
    admissions, _ = _admissions(tcfg.vocab_size)
    pt = np.full((SLOTS, MAX_PAGES), SENT, np.int32)
    first_j, first_t = [], []
    rngs = np.zeros((SLOTS, 2), np.uint32)
    for slot, suffix, length, hist, row, cow, bucket in admissions:
        padded = _pad(suffix, bucket)
        tok, jc, jkey = jgd.prefill_into_slot_paged(
            jp, jc, jnp.asarray(padded), jnp.int32(length),
            jnp.int32(hist), jnp.asarray(row), jnp.int32(cow),
            jnp.int32(slot), jax.random.PRNGKey(slot + 5), cfg=jcfg,
            page_size=PS, temperature=temperature, kv_dtype=kv_dtype)
        first_j.append(int(tok))
        ttok, rngs[slot] = tgd.prefill_into_slot_paged(
            tp, tc, padded, length, hist, row, cow, slot,
            prng.PRNGKey(slot + 5), cfg=tcfg, page_size=PS,
            temperature=temperature, kv_dtype=kv_dtype)
        first_t.append(ttok)
        np.testing.assert_array_equal(rngs[slot], np.asarray(jkey))
        pt[slot] = row
    assert first_t == first_j
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), [13, 14, 17, 0])

    # Map the pages the chunk writes (pos .. pos + K - 1).
    pt[0, 2] = 11
    pt[1, 2] = 12
    active = np.array([True, True, True, False])
    token = np.array(first_t + [0], np.int32)
    jtoks, jc, jdone, jrngs = jgd.decode_chunk_slots_paged(
        jp, jc, jnp.asarray(token), jnp.asarray(rngs),
        jnp.asarray(active), jnp.asarray(pt), cfg=jcfg, k=K, page_size=PS,
        temperature=temperature, eos_token=-1, kv_dtype=kv_dtype,
        attn_kernel="gather")
    ttoks, tdone, trngs = tgd.decode_chunk_slots_paged(
        tp, tc, token, rngs, active, pt, cfg=tcfg, k=K, page_size=PS,
        temperature=temperature, kv_dtype=kv_dtype,
        attn_kernel=attn_kernel)
    assert ttoks.shape == (SLOTS, K) and ttoks.dtype == np.int32
    np.testing.assert_array_equal(ttoks[active], np.asarray(jtoks)[active])
    np.testing.assert_array_equal(trngs[active], np.asarray(jrngs)[active])
    assert not tdone.any()
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    # The pool at every held position (slot b holds [0, pos[b])).
    pos = tc["pos"].numpy()
    held = sorted({(int(pt[b, t // PS]), t % PS)
                   for b in range(SLOTS) for t in range(pos[b])})
    pages = np.array([h[0] for h in held])
    offs = np.array([h[1] for h in held])
    for side in ("k", "v"):
        got = tc[side].numpy()[:, pages, offs]
        ref = np.asarray(jc[side])[:, pages, offs]
        if kv_dtype == "fp":
            # Same f32 values up to summation order in the projections.
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        else:
            # Codes round K/V values that agree to ~1e-6, so a code may
            # land one step apart where a value sits on a .5 boundary;
            # scales are absmax/127 of the same values.
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
            assert (got != ref).mean() < 1e-3
            np.testing.assert_allclose(
                tc[side + "s"].numpy(), np.asarray(jc[side + "s"]),
                rtol=1e-5, atol=0)


def test_prefill_cow_fork_matches_fresh_prefill(setup):
    """A mid-page prefix hit forks the partial page; the suffix prefill
    over the forked history gives the same first token as a fresh
    prefill of the whole prompt, and the source page is untouched."""
    _jcfg, tcfg, _jp, tp = setup
    admissions, prompts = _admissions(tcfg.vocab_size)
    cache = tgd.init_paged_cache(tcfg, SLOTS, N_PAGES, PS, "fp", "cpu")
    slot, suffix, length, hist, row, cow, bucket = admissions[0]
    tgd.prefill_into_slot_paged(tp, cache, _pad(suffix, bucket), length,
                                hist, row, cow, slot, KEY, cfg=tcfg,
                                page_size=PS)
    src_before = cache["k"][:, 5].clone()
    slot, suffix, length, hist, row, cow, bucket = admissions[2]
    forked, _ = tgd.prefill_into_slot_paged(
        tp, cache, _pad(suffix, bucket), length, hist, row, cow, slot, KEY,
        cfg=tcfg, page_size=PS)
    assert torch.equal(cache["k"][:, 5], src_before)
    fresh_cache = tgd.init_paged_cache(tcfg, SLOTS, N_PAGES, PS, "fp",
                                       "cpu")
    fresh, _ = tgd.prefill_into_slot_paged(
        tp, fresh_cache, _pad(prompts[2], 32), 17, 0, _row([1, 2, 4]),
        SENT, 0, KEY, cfg=tcfg, page_size=PS)
    assert forked == fresh
