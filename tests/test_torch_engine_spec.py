"""The port's DecodeEngine with seeded sampling, the flat pool and
speculative decoding, on the CPU at nano size with an f32 compute dtype,
held against the reference ``ray_tpu.serve.engine.DecodeEngine`` on the
same weights.

Every stream must be token-identical to the reference engine's for the
same prompt, knobs and seed: paged fp, paged int8 and flat pools at
temperature 0.8; a starved pool that preempts by recompute at 0.8; spec
engines with the n-gram drafter and with a ``ModelDrafter`` carrying the
reference drafter's weights, at 0 and 0.8. At temperature 0 spec streams
also equal ``generate_chunked`` (the committed stream is the greedy one
for any drafter).
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
from ray_tpu.serve import draft as jdraft
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import draft as tdraft
from ray_tpu_torch.serve.engine import DecodeEngine
from torch_threads import one_torch_thread  # noqa: F401

NANO = jgpt.CONFIGS["nano"]
J32 = dataclasses.replace(NANO, dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=3, chunk=4, max_len=64, prompt_buckets=(8, 16))


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), NANO)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def unaliased_pos(drafter):
    """The reference ``ModelDrafter`` uploads its host cursor with
    ``jnp.asarray(self._pos)``, which on the CPU may alias the numpy
    buffer it then advances in place (``tests/test_torch_spec.py`` says
    more); a strided view cannot be aliased."""
    drafter._pos = np.zeros(2 * drafter.slots, np.int32)[::2]
    return drafter


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, NANO.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _drain(eng, prompts, max_news, seeds):
    """Every request at once, one consumer thread each."""
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


def _both(jax_params, torch_params, prompts, max_news, seeds, *,
          ref_kw=None, **kw):
    """The same requests through the reference engine and the port's;
    returns (reference streams, port streams, port engine stats)."""
    ref = JaxEngine(jax_params, J32, **{**KW, **kw, **(ref_kw or {})})
    eng = DecodeEngine(torch_params, T32, device="cpu", **dict(KW, **kw))
    try:
        if isinstance(ref._drafter, jdraft.ModelDrafter):
            unaliased_pos(ref._drafter)
        refs = _drain(ref, prompts, max_news, seeds)
        outs = _drain(eng, prompts, max_news, seeds)
        return refs, outs, eng.stats()
    finally:
        ref.shutdown()
        eng.shutdown()


def _assert_streams(outs, refs):
    for i, (o, r) in enumerate(zip(outs, refs)):
        np.testing.assert_array_equal(o, r, err_msg=f"stream {i}")


@pytest.mark.parametrize("pool", ["paged-fp", "paged-int8", "flat"])
def test_seeded_streams_match_reference(jax_params, torch_params, pool):
    """Temperature 0.8, per-request seeds (two requests share a seed and
    a prompt, and must agree)."""
    prompts = _prompts(20, [5, 11, 16, 7])
    prompts.append(prompts[1])
    max_news = [12, 9, 14, 10, 9]
    seeds = [0, 7, 2 ** 31 - 1, -3, 7]
    kw = dict(temperature=0.8)
    if pool == "flat":
        kw.update(paged=False)
    else:
        kw.update(page_size=8, kv_dtype=pool.split("-")[1])
        kw.update(attn_kernel="gather")
    refs, outs, st = _both(jax_params, torch_params, prompts, max_news,
                           seeds, ref_kw=dict(paged=pool != "flat"), **kw)
    _assert_streams(outs, refs)
    np.testing.assert_array_equal(outs[1], outs[4])
    assert st["paged"] == (pool != "flat") and st["completed"] == 5
    # A sampled stream is not the greedy one.
    greedy = np.concatenate([s[0] for s in jgd.generate_chunked(
        jax_params, prompts[0][None], J32, 12, chunk=4, max_len=64)])
    assert not np.array_equal(outs[0], greedy)


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_starved_pool_replays_sampled_streams(jax_params, torch_params,
                                              spec):
    """A pool too small for 5 concurrent generations at temperature 0.8,
    plain and speculative: lanes park and the youngest is preempted by
    recompute; its replay draws the same seeded stream (and, with a
    drafter, takes the same acceptance pattern), so every stream equals
    the reference engine's on an unstarved pool."""
    prompts = _prompts(21, [16] * 5)
    max_news = [24, 20, 28, 16, 24]
    seeds = [11, 12, 13, 14, 15]
    ref = JaxEngine(jax_params, J32, paged=True, temperature=0.8,
                    page_size=8, spec_decode=spec, **KW)
    eng = DecodeEngine(torch_params, T32, device="cpu", temperature=0.8,
                       page_size=8, n_pages=11, prefix_cache=False,
                       attn_kernel="gather", spec_decode=spec,
                       **dict(KW, slots=4, prompt_buckets=(16,)))
    try:
        refs = _drain(ref, prompts, max_news, seeds)
        outs = _drain(eng, prompts, max_news, seeds)
        st = eng.stats()
    finally:
        ref.shutdown()
        eng.shutdown()
    assert st["lane_parks"] > 0 and st["preempted"] > 0, st
    _assert_streams(outs, refs)


def _jax_model_drafter(jax_params):
    jdp, jdcfg = jdraft.tied_drafter_params(jax_params, NANO, seed=1)
    return jdp, dataclasses.replace(jdcfg, dtype=jnp.float32)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("drafter", ["ngram", "model", "self"])
def test_spec_streams_match_reference(jax_params, torch_params, drafter,
                                      temperature):
    """Paged spec engines, ``draft_k=4``. A model drafter carries the
    same weights on both sides, so acceptance, and with it the PRNG
    chain at 0.8, follows the same pattern: ``"model"`` the reference's
    tied drafter (a random one-layer trunk, which the target rarely
    agrees with), ``"self"`` the target's own weights (at temperature 0
    accepted often: full rounds and the drafter's one-token ingest)."""
    # Constant-token prompts steer decoding into repeats the n-gram
    # table predicts, so rounds accept more than zero drafts.
    prompts = [np.full((9,), t, np.int32) for t in (3, 50)] + \
        _prompts(22, [13])
    max_news = [18, 15, 20]
    seeds = [1, 2, 3]
    if drafter != "ngram":
        jdp, jdcfg = _jax_model_drafter(jax_params) if drafter == "model" \
            else (jax_params, J32)
        spec = dict(spec_decode=jdraft.ModelDrafter(jdp, jdcfg))
        port = tdraft.ModelDrafter(
            tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp),
                                   "cpu"),
            dataclasses.replace(T32, n_layer=jdcfg.n_layer), device="cpu")
    else:
        spec, port = dict(spec_decode="ngram"), "ngram"
    refs, outs, st = _both(
        jax_params, torch_params, prompts, max_news, seeds,
        ref_kw=dict(paged=True, **spec), temperature=temperature,
        page_size=8, attn_kernel="gather", spec_decode=port, draft_k=4)
    _assert_streams(outs, refs)
    sp = st["spec"]
    assert sp["drafter"] == ("model" if drafter == "self" else drafter)
    assert sp["rounds"] > 0 and sp["accepted_per_forward"] >= 1.0, sp
    if temperature == 0.0 and drafter != "model":
        # Random nano weights give near-flat distributions, so at 0.8 a
        # draft's probability (its acceptance chance) is small.
        assert sp["accepted"] > 0, sp
    if temperature == 0.0:
        for p, m, o in zip(prompts, max_news, outs):
            ref = np.concatenate([s[0] for s in jgd.generate_chunked(
                jax_params, p[None], J32, m, chunk=4, max_len=64)])
            np.testing.assert_array_equal(o, ref)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_eos_matches_reference(jax_params, torch_params, temperature):
    """An EOS token taken from the middle of a stream: spec engines on
    both sides cut that stream at it (and free its slot) at the same
    place, at temperature 0 and seeded 0.8."""
    prompts = [np.full((9,), 3, np.int32)] + _prompts(25, [6, 14])
    max_news, seeds = [16, 14, 12], [4, 5, 6]
    kw = dict(temperature=temperature, page_size=8, attn_kernel="gather",
              spec_decode="ngram", draft_k=3)
    refs, _, _ = _both(jax_params, torch_params, prompts, max_news, seeds,
                       ref_kw=dict(paged=True), **kw)
    eos = int(refs[1][4])
    cut = int(np.flatnonzero(refs[1] == eos)[0]) + 1
    refs, outs, st = _both(jax_params, torch_params, prompts, max_news,
                           seeds, ref_kw=dict(paged=True), eos_token=eos,
                           **kw)
    _assert_streams(outs, refs)
    assert len(outs[1]) == cut and outs[1][-1] == eos
    assert st["completed"] == 3 and st["active_slots"] == 0


def test_spec_always_wrong_drafter_is_exact(jax_params, torch_params):
    """A drafter whose proposals are never the target's: acceptance 0,
    one token per lane per round, and the streams still equal
    ``generate_chunked``'s (the correction token is the target's own)."""
    class AlwaysWrong(tdraft.Drafter):
        name = "always_wrong"

        def propose(self, active, last):
            return ((np.asarray(last)[:, None] + 1 + np.arange(
                self.draft_k)) % NANO.vocab_size).astype(np.int32)

    prompts = _prompts(26, [5, 8, 16])
    max_news = [10, 14, 7]
    eng = DecodeEngine(torch_params, T32, device="cpu", page_size=8,
                       attn_kernel="gather", spec_decode=AlwaysWrong(),
                       **KW)
    try:
        outs = _drain(eng, prompts, max_news, [0, 0, 0])
        sp = eng.stats()["spec"]
    finally:
        eng.shutdown()
    assert sp["drafter"] == "always_wrong" and sp["accepted"] == 0
    assert sp["accepted_per_forward"] == 1.0 and sp["rounds"] > 0
    for p, m, o in zip(prompts, max_news, outs):
        ref = np.concatenate([s[0] for s in jgd.generate_chunked(
            jax_params, p[None], J32, m, chunk=4, max_len=64)])
        np.testing.assert_array_equal(o, ref)


def test_flat_spec_and_resume(jax_params, torch_params):
    """A flat-pool n-gram spec engine at 0.8: streams equal the
    reference's; a second engine asked to ``resume_from=5`` the same
    seeded request delivers exactly the rest."""
    prompts = [np.full((8,), 9, np.int32)] + _prompts(23, [12])
    max_news, seeds = [16, 14], [5, 6]
    refs, outs, st = _both(jax_params, torch_params, prompts, max_news,
                           seeds, ref_kw=dict(paged=False),
                           temperature=0.8, paged=False,
                           spec_decode="ngram")
    _assert_streams(outs, refs)
    assert st["spec"]["rounds"] > 0
    eng = DecodeEngine(torch_params, T32, device="cpu", temperature=0.8,
                       paged=False, spec_decode="ngram", **KW)
    try:
        tail = np.concatenate(list(eng.stream(prompts[0], 16, seed=5,
                                              resume_from=5)))
        assert eng.stats()["resumed"] == 1
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(tail, refs[0][5:])


def test_spec_threshold_falls_back_to_chunks(jax_params, torch_params):
    """``spec_threshold`` above any n-gram estimate on random prompts:
    every round falls back to a plain chunk (on a paged pool through
    the chunk kernel path), and the streams stay the greedy ones."""
    prompts = _prompts(24, [6, 15])
    max_news = [12, 10]
    eng = DecodeEngine(torch_params, T32, device="cpu", page_size=8,
                       attn_kernel="cuda", spec_decode="ngram",
                       spec_threshold=100.0, **KW)
    try:
        outs = _drain(eng, prompts, max_news, [0, 0])
        sp = eng.stats()["spec"]
    finally:
        eng.shutdown()
    assert sp["fallback_rounds"] > 0 and sp["rounds"] == 0, sp
    for p, m, o in zip(prompts, max_news, outs):
        ref = np.concatenate([s[0] for s in jgd.generate_chunked(
            jax_params, p[None], J32, m, chunk=4, max_len=64)])
        np.testing.assert_array_equal(o, ref)


def test_spec_and_pool_guards(torch_params):
    """The reference's guards: adaptive speculation needs temperature 0,
    at construction and through ``ensure_spec``; a live engine refuses
    ``ensure_spec`` changes; a flat pool takes no paged knobs; a bad
    ``resume_from`` or ``draft_k`` raises."""
    def make(**kw):
        return DecodeEngine(torch_params, T32, device="cpu",
                            auto_start=False, **dict(KW, **kw))

    with pytest.raises(ValueError, match="temperature 0"):
        make(temperature=0.8, spec_decode="ngram", spec_threshold=1.0)
    with pytest.raises(ValueError, match="draft_k"):
        make(spec_decode="ngram", draft_k=0)
    with pytest.raises(ValueError, match="paged-pool knobs"):
        make(paged=False, attn_kernel="cuda")
    with pytest.raises(ValueError, match="paged-pool knobs"):
        make(paged=False, kv_dtype="int8")
    eng = make(temperature=0.8, spec_decode="ngram")
    with pytest.raises(ValueError, match="temperature 0"):
        eng.ensure_spec(spec_threshold=1.0)
    with pytest.raises(ValueError, match="resume_from"):
        eng.submit(np.zeros(4, np.int32), 5, resume_from=6)
    eng.shutdown()

    eng = make(page_size=8, attn_kernel="gather")
    assert eng.ensure_spec() is eng and eng.stats().get("spec") is None
    eng.ensure_spec("ngram", draft_k=3)       # never used: reconfigures
    assert eng.stats()["spec"]["draft_k"] == 3
    eng.ensure_spec("ngram", draft_k=3)       # matching: a no-op
    eng.start()
    try:
        np.concatenate(list(eng.stream(np.arange(5, dtype=np.int32), 6)))
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_spec("model")
        with pytest.raises(ValueError, match="live engine"):
            eng.ensure_spec(draft_k=5)
    finally:
        eng.shutdown()
