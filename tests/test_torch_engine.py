"""The port's DecodeEngine (``ray_tpu_torch.serve.engine``) on the CPU at
nano size, held against the JAX reference on the same weights.

At an f32 compute dtype and temperature 0 every stream must be
token-identical to the reference's ``generate_chunked`` (the oracle the
reference engine's own tests use) — through concurrency, EOS, a shared
system prompt (page-aligned prefix hit and mid-page COW fork), and a
starved pool that forces parking and recompute preemption — and an int8
pool must match the reference's paged engine with ``kv_dtype="int8"``.
At bf16 the two frameworks round at different places, so streams are
held to a divergence budget instead.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve.engine import DecodeEngine
from torch_threads import one_torch_thread  # noqa: F401

NANO = jgpt.CONFIGS["nano"]
J32 = dataclasses.replace(NANO, dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), NANO)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def _ref(jp, prompt, cfg, max_new, **kw):
    return np.concatenate([s[0] for s in jgd.generate_chunked(
        jp, np.asarray(prompt)[None], cfg, max_new, chunk=4, max_len=64,
        **kw)])


def _engine(tp, cfg=T32, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("chunk", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", (8, 16))
    kw.setdefault("page_size", 8)
    kw.setdefault("attn_kernel", "gather")
    return DecodeEngine(tp, cfg, device="cpu", **kw)


def _drain_concurrent(eng, prompts, max_news):
    outs = {}

    def consume(i):
        outs[i] = np.concatenate(list(eng.stream(prompts[i], max_news[i])))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return [outs[i] for i in range(len(prompts))]


def _prompts(rng, lens):
    return [rng.integers(0, NANO.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def test_streams_match_generate_chunked(jax_params, torch_params):
    """Concurrent requests, EOS, and a shared system prompt: a cold run
    seeds the prefix cache, then a page-aligned hit and an exact repeat
    (mid-page hit, COW fork) run concurrently with fresh prompts."""
    rng = np.random.default_rng(0)
    sysp = _prompts(rng, [8])[0]
    a = np.concatenate([sysp, _prompts(rng, [5])[0]])       # 13 tokens
    b = np.concatenate([sysp, _prompts(rng, [5])[0]])
    prompts = [b, a] + _prompts(rng, [5, 16])
    max_news = [10, 9, 12, 7]
    plain = [_ref(jax_params, p, J32, m) for p, m in zip(prompts, max_news)]
    # EOS: a token the reference emits mid-stream in one lane.
    eos = int(plain[2][3])
    refs = [_ref(jax_params, p, J32, m, eos_token=eos)
            for p, m in zip(prompts, max_news)]
    assert any(len(r) < m for r, m in zip(refs, max_news))
    eng = _engine(torch_params, eos_token=eos)
    try:
        cold = np.concatenate(list(eng.stream(a, 9)))
        np.testing.assert_array_equal(cold, refs[1])
        outs = _drain_concurrent(eng, prompts, max_news)
        for i, (o, r) in enumerate(zip(outs, refs)):
            np.testing.assert_array_equal(o, r, err_msg=f"stream {i}")
        st = eng.stats()
        assert st["prefix_hits"] >= 2 and st["cow_copies"] >= 1, st
        assert st["completed"] == 5 and st["active_slots"] == 0
    finally:
        eng.shutdown()


def test_starved_pool_parks_and_preempts(jax_params, torch_params):
    """A pool too small for 6 concurrent long generations: lanes park
    when pages run out and, on full deadlock, the youngest is preempted
    by recompute — every stream still equals the reference."""
    rng = np.random.default_rng(4)
    prompts = _prompts(rng, [16] * 6)
    max_news = [24, 20, 28, 16, 24, 20]
    refs = [_ref(jax_params, p, J32, m) for p, m in zip(prompts, max_news)]
    eng = _engine(torch_params, slots=4, prompt_buckets=(16,), n_pages=11,
                  prefix_cache=False)
    try:
        outs = _drain_concurrent(eng, prompts, max_news)
        st = eng.stats()
        assert st["completed"] == 6 and st["admitted"] == 6
        assert st["lane_parks"] > 0 and st["preempted"] > 0, st
        for i, (o, r) in enumerate(zip(outs, refs)):
            np.testing.assert_array_equal(o, r, err_msg=f"stream {i}")
        assert st["pages_free"] == 11
    finally:
        eng.shutdown()


def test_int8_matches_reference_paged_engine(jax_params, torch_params):
    """int8 pools: the same quantizer on both sides (monotone scales,
    fresh-page reset, canonical zeros) gives the same streams as the
    reference's paged engine with ``kv_dtype="int8"``, prefix COW
    included."""
    from ray_tpu.serve.engine import DecodeEngine as JaxEngine

    rng = np.random.default_rng(6)
    sysp = _prompts(rng, [12])[0]
    prompts = _prompts(rng, [5, 11, 16]) + [
        np.concatenate([sysp, t]) for t in _prompts(rng, [4, 4])]
    max_news = [9, 7, 12, 8, 8]
    kw = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16),
              page_size=8, kv_dtype="int8")
    ref_eng = JaxEngine(jax_params, J32, paged=True, **kw)
    eng = _engine(torch_params, **kw)
    try:
        refs = _drain_concurrent(ref_eng, prompts, max_news)
        outs = _drain_concurrent(eng, prompts, max_news)
        for i, (o, r) in enumerate(zip(outs, refs)):
            np.testing.assert_array_equal(o, r, err_msg=f"stream {i}")
        assert eng.stats()["prefix_hits"] >= 1
    finally:
        ref_eng.shutdown()
        eng.shutdown()


def test_bf16_divergence_budget(jax_params):
    """bf16 compute: the frameworks' kernels round activations at other
    places, so greedy streams may part ways at a near-tie. Budget: every
    FIRST token agrees and at most half of the streams diverge anywhere
    (measured: 0 of 8 diverge on these nano weights)."""
    tp = tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu",
        dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    prompts = _prompts(rng, [6, 9, 12, 16] * 2)
    max_news = [8] * len(prompts)
    refs = [_ref(jax_params, p, NANO, m) for p, m in zip(prompts, max_news)]
    eng = _engine(tp, cfg=tgpt.CONFIGS["nano"], prefix_cache=False)
    try:
        outs = _drain_concurrent(eng, prompts, max_news)
    finally:
        eng.shutdown()
    assert all(o[0] == r[0] for o, r in zip(outs, refs))
    diverged = sum(not np.array_equal(o, r) for o, r in zip(outs, refs))
    assert diverged <= len(prompts) // 2, diverged


def test_engine_guards(torch_params):
    """Knob validation, at construction. (Temperature > 0 serves since
    the threefry PRNG was ported; ``tests/test_torch_engine_spec.py``
    holds its streams to the reference's.)"""
    with pytest.raises(ValueError, match="attn_kernel"):
        _engine(torch_params, attn_kernel="pallas", auto_start=False)
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(torch_params, kv_dtype="int4", auto_start=False)
    eng = _engine(torch_params, auto_start=False)
    with pytest.raises(ValueError, match="exceeds cache"):
        eng.submit(np.zeros(16, np.int32), 60)
    eng.shutdown()
