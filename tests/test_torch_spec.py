"""Speculative decoding's device half and drafters in the port
(``ray_tpu_torch.models.gpt_decode._spec_accept``/``verify_chunk_slots``/
``verify_chunk_slots_paged``, ``ray_tpu_torch.serve.draft``) against the
JAX reference on the CPU, nano weights at an f32 compute dtype.

Committed tokens, accepted counts, returned PRNG lanes and ``pos`` must
be identical at temperature 0 and at a seeded 0.8. The pools after a
verify are held by what a following decode chunk reads from them: its
tokens must be identical too. ``NGramDrafter`` proposals and estimates
must equal the reference's on the same streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu.serve import draft as jdraft
from ray_tpu_torch._private import prng
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import gpt_decode as tgd
from ray_tpu_torch.serve import draft as tdraft
from torch_threads import one_torch_thread  # noqa: F401

K = 4
SLOTS = 3
MAX_LEN = 48
PS = 8
MAX_PAGES = MAX_LEN // PS


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jgpt.CONFIGS["nano"])
    tp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_accept_identical(temperature):
    """Peaked random logits; drafts take row i's argmax with probability
    0.7, so acceptance runs of every length occur."""
    rng = np.random.default_rng(3)
    B, V = 8, 64
    logits = (rng.standard_normal((B, K + 1, V)) * 4).astype(np.float32)
    am = logits.argmax(-1)
    draft = np.where(rng.random((B, K)) < 0.7, am[:, :K],
                     rng.integers(0, V, (B, K))).astype(np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s))
                     for s in range(B)])
    jc, jn, jk = jgd._spec_accept(jnp.asarray(logits), jnp.asarray(draft),
                                  jnp.asarray(keys), temperature, K)
    tc, tn, tk = tgd._spec_accept(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.from_numpy(keys.astype(np.int64)), temperature, K)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jk))
    assert len(set(np.asarray(jn).tolist())) >= 3      # varied acceptance


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in (5, 13, 16)]


def _drafts(greedy_next, rng, vocab):
    """Drafts per slot: the true greedy continuation for slot 0, a
    half-right one for slot 1, random for slot 2."""
    d = rng.integers(0, vocab, (SLOTS, K)).astype(np.int32)
    d[0] = greedy_next[0]
    d[1, :2] = greedy_next[1, :2]
    return d


def _run_verify(setup, temperature, layout, kv_dtype="fp"):
    jcfg, tcfg, jp, tp = setup
    paged = layout == "paged"
    if paged:
        n_pages = SLOTS * MAX_PAGES
        jc = jgd.init_paged_cache(jcfg, SLOTS, n_pages, PS, kv_dtype)
        tc = tgd.init_paged_cache(tcfg, SLOTS, n_pages, PS, kv_dtype,
                                  "cpu")
        # Slot b owns pages b, b+3, b+6, ... (interleaved).
        pt = np.stack([np.arange(MAX_PAGES) * SLOTS + b
                       for b in range(SLOTS)]).astype(np.int32)
    else:
        jc = jgd.init_slot_cache(jcfg, SLOTS, MAX_LEN)
        tc = tgd.init_slot_cache(tcfg, SLOTS, MAX_LEN, "cpu")
    token = np.zeros(SLOTS, np.int32)
    rngs = np.zeros((SLOTS, 2), np.uint32)
    for slot, p in enumerate(_prompts(tcfg.vocab_size)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        key = prng.PRNGKey(100 + slot)
        if paged:
            jt, jc, _ = jgd.prefill_into_slot_paged(
                jp, jc, jnp.asarray(padded), jnp.int32(len(p)),
                jnp.int32(0), jnp.asarray(pt[slot]),
                jnp.int32(tgd.PT_SENTINEL), jnp.int32(slot),
                jnp.asarray(key), cfg=jcfg, page_size=PS,
                temperature=temperature, kv_dtype=kv_dtype)
            token[slot], rngs[slot] = tgd.prefill_into_slot_paged(
                tp, tc, padded, len(p), 0, pt[slot], tgd.PT_SENTINEL,
                slot, key, cfg=tcfg, page_size=PS,
                temperature=temperature, kv_dtype=kv_dtype)
        else:
            jt, jc, _ = jgd.prefill_into_slot(
                jp, jc, jnp.asarray(padded), jnp.int32(len(p)),
                jnp.int32(slot), jnp.asarray(key), cfg=jcfg,
                temperature=temperature)
            token[slot], rngs[slot] = tgd.prefill_into_slot(
                tp, tc, padded, len(p), slot, key, cfg=tcfg,
                temperature=temperature)
        assert token[slot] == int(jt)
    active = np.array([True, True, True])
    rng = np.random.default_rng(5)
    for rnd in range(3):
        # The greedy continuation (decoded on a scratch copy of the
        # port's pool) makes drafts that get accepted.
        scratch = {k: v.clone() for k, v in tc.items()}
        if paged:
            greedy, _, _ = tgd.decode_chunk_slots_paged(
                tp, scratch, token, rngs, active, pt, cfg=tcfg, k=K,
                page_size=PS, kv_dtype=kv_dtype)
        else:
            greedy, _, _ = tgd.decode_chunk_slots(tp, scratch, token, rngs,
                                                  active, cfg=tcfg, k=K)
        draft = _drafts(greedy, rng, tcfg.vocab_size)
        if paged:
            jcom, jn, jc, jr = jgd.verify_chunk_slots_paged(
                jp, jc, jnp.asarray(token), jnp.asarray(draft),
                jnp.asarray(rngs), jnp.asarray(active), jnp.asarray(pt),
                cfg=jcfg, k=K, page_size=PS, temperature=temperature,
                kv_dtype=kv_dtype)
            tcom, tn, tr = tgd.verify_chunk_slots_paged(
                tp, tc, token, draft, rngs, active, pt, cfg=tcfg, k=K,
                page_size=PS, temperature=temperature, kv_dtype=kv_dtype)
        else:
            jcom, jn, jc, jr = jgd.verify_chunk_slots(
                jp, jc, jnp.asarray(token), jnp.asarray(draft),
                jnp.asarray(rngs), jnp.asarray(active), cfg=jcfg, k=K,
                temperature=temperature)
            tcom, tn, tr = tgd.verify_chunk_slots(
                tp, tc, token, draft, rngs, active, cfg=tcfg, k=K,
                temperature=temperature)
        msg = f"round {rnd}"
        np.testing.assert_array_equal(tn, np.asarray(jn), err_msg=msg)
        np.testing.assert_array_equal(tcom, np.asarray(jcom), err_msg=msg)
        np.testing.assert_array_equal(tr, np.asarray(jr), err_msg=msg)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]), err_msg=msg)
        token = tcom[np.arange(SLOTS), tn]
        rngs = tr
        if temperature == 0.0:
            assert tn[0] == K, msg          # the true continuation
    # The pool as the next decode chunk reads it.
    if paged:
        jt, jc, _, jr = jgd.decode_chunk_slots_paged(
            jp, jc, jnp.asarray(token), jnp.asarray(rngs),
            jnp.asarray(active), jnp.asarray(pt), cfg=jcfg, k=K,
            page_size=PS, temperature=temperature, kv_dtype=kv_dtype)
        tt, _, tr = tgd.decode_chunk_slots_paged(
            tp, tc, token, rngs, active, pt, cfg=tcfg, k=K, page_size=PS,
            temperature=temperature, kv_dtype=kv_dtype)
    else:
        jt, jc, _, jr = jgd.decode_chunk_slots(
            jp, jc, jnp.asarray(token), jnp.asarray(rngs),
            jnp.asarray(active), cfg=jcfg, k=K, temperature=temperature)
        tt, _, tr = tgd.decode_chunk_slots(tp, tc, token, rngs, active,
                                           cfg=tcfg, k=K,
                                           temperature=temperature)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tr, np.asarray(jr))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_verify_chunk_slots_flat(setup, temperature):
    _run_verify(setup, temperature, "flat")


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_verify_chunk_slots_paged(setup, temperature, kv_dtype):
    _run_verify(setup, temperature, "paged", kv_dtype)


def test_ngram_drafter_matches_reference():
    """The same admissions and committed rounds through both drafters:
    proposals and self-estimates equal at every round, chunk-round
    observes (``accepted=-1``) included."""
    rng = np.random.default_rng(9)
    ref, got = jdraft.NGramDrafter(max_n=3), tdraft.NGramDrafter(max_n=3)
    for d in (ref, got):
        d.configure(slots=3, max_len=64, prompt_buckets=(16,), draft_k=4)
    # Repetitive prompts so contexts recur; slot 1 stays empty.
    prompts = {0: np.tile(rng.integers(0, 9, 5), 3).astype(np.int32),
               2: rng.integers(0, 6, 12).astype(np.int32)}
    for slot, p in prompts.items():
        ref.admit(slot, p, int(p[0]))
        got.admit(slot, p, int(p[0]))
    active = np.array([True, False, True])
    last = np.array([prompts[0][0], 0, prompts[2][0]], np.int32)
    for rnd in range(6):
        pr = ref.propose(active, last)
        pg = got.propose(active, last)
        np.testing.assert_array_equal(pg[active], pr[active],
                                      err_msg=f"round {rnd}")
        for slot in (0, 2):
            n = int(rng.integers(1, 5))
            toks = np.concatenate([pr[slot, :n - 1],
                                   rng.integers(0, 9, 1)]).astype(np.int32)
            acc = -1 if rnd % 3 == 2 else n - 1
            ref.observe(slot, toks, acc)
            got.observe(slot, toks, acc)
            assert got.estimate(slot) == ref.estimate(slot)
            last[slot] = toks[-1]
    ref.free(0)
    got.free(0)
    assert got.estimate(0) == ref.estimate(0) == 0.0


def test_make_drafter_and_tied_params(setup):
    """``make_drafter`` resolves the knob as the reference does; the tied
    drafter shares the target's embedding tensors and lives on the
    target's device."""
    _jcfg, tcfg, _jp, tp = setup
    assert tdraft.make_drafter(None) is None
    assert tdraft.make_drafter(False) is None
    assert isinstance(tdraft.make_drafter(True), tdraft.NGramDrafter)
    assert isinstance(tdraft.make_drafter("ngram"), tdraft.NGramDrafter)
    md = tdraft.make_drafter("model", tp, tcfg)
    assert isinstance(md, tdraft.ModelDrafter)
    assert md.cfg.n_layer == 1 and md.device.type == "cpu"
    assert md.params["embed"] is tp["embed"]
    assert md.params["pos_embed"] is tp["pos_embed"]
    params, dcfg = tdraft.tied_drafter_params(tp, tcfg, seed=3)
    again, _ = tdraft.tied_drafter_params(tp, tcfg, seed=3)
    assert all(torch.equal(params[k], again[k]) for k in params)
    with pytest.raises(ValueError, match="spec_decode"):
        tdraft.make_drafter("bogus")
    with pytest.raises(ValueError, match="params/cfg"):
        tdraft.make_drafter("model")


def unaliased_pos(drafter):
    """Work around a defect of the reference's ``ModelDrafter`` on the
    CPU: ``propose`` uploads its host cursor with ``jnp.asarray(self._pos)``,
    which may alias the numpy buffer (it does for aligned arrays), and
    then advances ``self._pos`` in place, moving the device cursor too.
    A strided view cannot be aliased, so the reference then behaves as
    its code intends. Call after ``configure``."""
    drafter._pos = np.zeros(2 * drafter.slots, np.int32)[::2]
    return drafter


def test_model_drafter_matches_reference(setup):
    """A ``ModelDrafter`` carrying the reference drafter's weights
    proposes what the reference's proposes, through partial and full
    acceptance (the lazy one-token ingest) and a rollback."""
    jcfg, tcfg, jp, tp = setup
    jdp, jdcfg = jdraft.tied_drafter_params(jp, jgpt.CONFIGS["nano"],
                                            seed=1)
    jdcfg = dataclasses.replace(jdcfg, dtype=jnp.float32)
    tdp = tgpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp),
                                 "cpu")
    tdcfg = dataclasses.replace(tcfg, n_layer=1)
    ref = jdraft.ModelDrafter(jdp, jdcfg)
    got = tdraft.ModelDrafter(tdp, tdcfg, device="cpu")
    for d in (ref, got):
        d.configure(slots=2, max_len=MAX_LEN, prompt_buckets=(16,),
                    draft_k=K)
    unaliased_pos(ref)
    prompts = _prompts(tcfg.vocab_size)[:2]
    for slot, p in enumerate(prompts):
        ref.admit(slot, p, 7)
        got.admit(slot, p, 7)
    active = np.array([True, True])
    last = np.array([7, 7], np.int32)
    for rnd, accepted in enumerate([(4, 1), (0, 4), (2, 3)]):
        pr = np.asarray(ref.propose(active, last))
        pg = got.propose(active, last)
        np.testing.assert_array_equal(pg, pr, err_msg=f"round {rnd}")
        for slot, a in enumerate(accepted):
            toks = np.concatenate([pr[slot, :a], [(rnd * 7 + slot) % 50]]
                                  ).astype(np.int32)
            ref.observe(slot, toks, a)
            got.observe(slot, toks, a)
            last[slot] = toks[-1]
        np.testing.assert_array_equal(got._pos, ref._pos)
        np.testing.assert_array_equal(got._pending, ref._pending)


def test_model_drafter_defaults_to_the_card(setup):
    """Without ``device``, a ``ModelDrafter`` (and so ``make_drafter(
    "model", ...)`` on card-resident weights) resolves to ``cuda`` and
    raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    _jcfg, tcfg, _jp, tp = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdraft.ModelDrafter(tp, tcfg)
