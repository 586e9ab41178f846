"""Tensor-parallel decode in the port at module level, held against the
reference and against the port's own tp=1 path on the CPU at nano size,
f32 compute, with gloo groups of follower processes; and the groups'
lifecycle.

- ``shard_params``: rank r's slice of every weight equals the
  reference's addressable shard r under ``_tp_param_specs``, at tp 2
  and 4.
- ``_mm_row(group=None)`` is ``_mm``, bit for bit.
- The same prompts, tokens, keys and draft through prefill, one decode
  step, a greedy and a seeded decode chunk, a verify and an export, on
  a flat, a paged fp and a paged int8 pool, at tp 2 and 4 against tp=1:
  logits and K/V within :data:`F32_TOL` (the row-parallel sums add the
  same f32 products in another order), every token, key and accepted
  count identical.
- The same shipped K/V imported into a tp=1 pool, a tp=N pool and the
  reference's tp=N pool export the same bytes from all three.
- A closed group leaves no process; followers end with their parent; a
  collective no follower answers raises within the group's timeout; a
  call the engine calls stale is refused before any rank sees it.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu_torch._private import prng
from ray_tpu_torch._private import tp as ttp
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import gpt_decode as tgd
from torch_threads import one_torch_thread  # noqa: F401

# Four heads, so that tp=4 divides them; otherwise nano.
J4 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32, n_head=4)
T4 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                         n_head=4)
#: tp=N against tp=1, f32: logits of magnitude ~1 and K/V ~1, summed in
#: another order over two layers; measured differences ~1e-6.
F32_TOL = 1e-4
SLOTS, PS, MAX_PAGES, N_PAGES, K = 3, 8, 8, 30, 4
LENS = (5, 12, 20)
KINDS = ("flat", "fp", "int8")


@pytest.fixture(scope="module")
def torch_params():
    return tgpt.init_params(T4, 0, device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), J4)


def _group(tp: int):
    return ttp.decode_group(tp, device="cpu")


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_match_reference_shards(tp, torch_params,
                                             jax_params):
    from ray_tpu._private.jax_compat import decode_mesh

    ref = jgd.shard_params(jax_params, J4, tp)
    mesh = list(decode_mesh(tp).devices.flat)
    leaves = {"embed": ref["embed"]["kernel"],
              "pos_embed": ref["pos_embed"],
              "ln_f_scale": ref["ln_f_scale"]}
    for name, leaf in ref["block"].items():
        leaves[name] = leaf["kernel"] if isinstance(leaf, dict) else leaf
    assert set(leaves) == set(torch_params)
    for rank in range(tp):
        mine = tgd.shard_params(torch_params, T4, tp, rank)
        for name, leaf in leaves.items():
            shard = next(s for s in leaf.addressable_shards
                         if mesh.index(s.device) == rank)
            np.testing.assert_array_equal(mine[name].numpy(),
                                          np.asarray(shard.data), name)
    assert tgd.shard_params(torch_params, T4, 1, 0) is torch_params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_row_without_group_is_mm(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    assert torch.equal(tgd._mm_row(x, w, dtype),
                       tgpt._mm(x, w, dtype))


# ------------------------------------------------- one pool, every call
def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, T4.vocab_size, (n,)).astype(np.int32)
            for n in LENS]


def _drive(run, params, cache, kind: str, draft=None):
    """Prefill every prompt, one decode step, a greedy then a seeded
    chunk, a verify of ``draft`` and each slot's export, through
    ``run(name)`` on ``cache``; returns what each call gave back. With
    no ``draft``, the greedy continuation to draft from instead."""
    paged, kv = kind != "flat", "int8" if kind == "int8" else "fp"
    pt = np.random.default_rng(8).permutation(N_PAGES)[
        :SLOTS * MAX_PAGES].reshape(SLOTS, MAX_PAGES).astype(np.int32)
    keys = np.stack([prng.PRNGKey(100 + s) for s in range(SLOTS)])
    out = {"first": []}
    for s, p in enumerate(_prompts()):
        padded = np.zeros((1, 32), np.int32)
        padded[0, :len(p)] = p
        if paged:
            tok, keys[s] = run("prefill_into_slot_paged")(
                params, cache, padded, len(p), 0, pt[s], tgd.PT_SENTINEL,
                s, keys[s], cfg=T4, page_size=PS, temperature=1.0,
                kv_dtype=kv)
        else:
            tok, keys[s] = run("prefill_into_slot")(
                params, cache, padded, len(p), s, keys[s], cfg=T4,
                temperature=1.0)
        out["first"].append(tok)
    active = np.array([True, True, False])
    pos = np.array(LENS)
    token = torch.tensor(out["first"], dtype=torch.int32)
    if paged:
        logits = run("_slot_decode_step_paged")(
            params, cache, token, active, pt, pos, T4, PS, kv, "cuda")
        chunk = run("decode_chunk_slots_paged")
        verify = run("verify_chunk_slots_paged")
        ckw = dict(pt=pt, page_size=PS, kv_dtype=kv, attn_kernel="cuda")
        vkw = dict(pt=pt, page_size=PS, kv_dtype=kv)
    else:
        logits = run("_slot_decode_step")(params, cache, token, active,
                                          pos, T4)
        chunk, verify = run("decode_chunk_slots"), run("verify_chunk_slots")
        ckw, vkw = {}, {}
    out["logits"] = logits[active].numpy()
    last = logits.argmax(-1).numpy().astype(np.int32)
    out["chunk0"] = chunk(params, cache, last, keys, active, cfg=T4, k=K,
                          **ckw)
    out["chunk1"] = chunk(params, cache, out["chunk0"][0][:, -1],
                          out["chunk0"][2], active, cfg=T4, k=K,
                          temperature=1.0, **ckw)
    toks, _, keys = out["chunk1"]
    if draft is None:
        return chunk(params, cache, toks[:, -1], keys, active, cfg=T4, k=3,
                     **ckw)[0]
    out["verify"] = verify(params, cache, toks[:, -1], draft, keys, active,
                           cfg=T4, k=3, temperature=0.0, **vkw)
    n = np.array(LENS) + active * (1 + 2 * K + 1 + out["verify"][1])
    out["export"] = [
        run("export_slot_kv_paged")(cache, pt[s], cfg=T4, page_size=PS,
                                    kv_dtype=kv, length=int(n[s]))
        if paged else run("export_slot_kv")(cache, s, cfg=T4,
                                            length=int(n[s]))
        for s in range(SLOTS)]
    return out


def _pool(kind: str) -> dict:
    if kind == "flat":
        return dict(fn="init_slot_cache", cfg=T4, slots=SLOTS,
                    max_len=MAX_PAGES * PS)
    return dict(fn="init_paged_cache", cfg=T4, slots=SLOTS,
                n_pages=N_PAGES, page_size=PS, kv_dtype=kind)


def _shards(tp: int, kind: str, params) -> ttp.Shards:
    sh = ttp.Shards(_group(tp), T4, params, torch.device("cpu"))
    kw = _pool(kind)
    sh.build(kw.pop("fn"), **kw)
    return sh


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", [2, 4])
def test_calls_match_tp1(tp, kind, torch_params):
    kw = _pool(kind)
    fn = getattr(tgd, kw.pop("fn"))
    draft = _drive(lambda name: getattr(tgd, name), torch_params,
                   fn(device="cpu", **kw), kind)
    draft[:, 2] = (draft[:, 2] + 1) % T4.vocab_size   # two accepted
    want = _drive(lambda name: getattr(tgd, name), torch_params,
                  fn(device="cpu", **kw), kind, draft)
    sh = _shards(tp, kind, torch_params)
    try:
        assert sh.cache["k"].shape[-2] == T4.n_head // tp
        got = _drive(lambda name: lambda *a, **k: sh.call(name, *a, **k),
                     sh.params, sh.cache, kind, draft)
    finally:
        sh.drop()
    assert got["first"] == want["first"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=F32_TOL)
    for name in ("chunk0", "chunk1", "verify"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w, name)
    assert got["verify"][1][:2].tolist() == [2, 2]
    for g, w in zip(got["export"], want["export"]):
        for gt, wt in zip(g, w):
            assert gt.shape == wt.shape
            if gt.dtype == torch.int8:           # codes: one step apart
                assert (gt.int() - wt.int()).abs().max() <= 1
            else:
                np.testing.assert_allclose(gt.numpy(), wt.numpy(), rtol=0,
                                           atol=F32_TOL)


# ---------------------------------------------------------- KV handoff
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", [2, 4])
def test_export_is_canonical(tp, kind, torch_params):
    """The same shipped K/V imported into a port tp=1 pool, a port tp=N
    pool (each rank taking its heads) and the reference's tp=N pool: all
    three export the shipped bytes."""
    L, H, hd, n = T4.n_layer, T4.n_head, T4.head_dim, 21
    rng = np.random.default_rng(3)
    quant = kind == "int8"
    if quant:
        ship = [rng.integers(-127, 128, (L, n, H, hd)).astype(np.int8)
                for _ in range(2)]
        n_cover = -(-n // PS)
        scales = [rng.uniform(0.01, 0.1, (L, n_cover, H)).astype(np.float32)
                  for _ in range(2)]
    else:
        ship = [rng.standard_normal((L, n, H, hd)).astype(np.float32)
                for _ in range(2)]
    pt = np.array([9, 3, 14, tgd.PT_SENTINEL], np.int32)
    slot = 1

    def roundtrip(run, cache, heads):
        if kind == "flat":
            run("import_slot_kv")(cache, heads(ship[0], -2),
                                  heads(ship[1], -2), slot, n, cfg=T4)
            return run("export_slot_kv")(cache, slot, cfg=T4, length=n)
        run("import_slot_kv_paged")(
            cache, heads(ship[0], -2), heads(ship[1], -2), pt, slot, n,
            cfg=T4, page_size=PS,
            ks_pages=heads(scales[0], -1) if quant else None,
            vs_pages=heads(scales[1], -1) if quant else None)
        return run("export_slot_kv_paged")(cache, pt, cfg=T4, page_size=PS,
                                           kv_dtype=kind if quant else "fp",
                                           length=n)

    kw = _pool(kind)
    one = roundtrip(lambda name: getattr(tgd, name),
                    getattr(tgd, kw.pop("fn"))(device="cpu", **kw),
                    lambda a, axis: a)
    sh = _shards(tp, kind, torch_params)
    try:
        many = roundtrip(lambda name: lambda *a, **k: sh.call(name, *a, **k),
                         sh.cache, ttp.Heads)
    finally:
        sh.drop()
    want = ship + (scales if quant else [])
    for a, b, w in zip(one, many, want):
        np.testing.assert_array_equal(a.numpy(), w)
        np.testing.assert_array_equal(b.numpy(), w)

    # The reference at the same tp: its import scatters into the mesh and
    # its export gathers the canonical layout (untrimmed, so cut here).
    if kind == "flat":
        jc = jgd.init_slot_cache(J4, SLOTS, MAX_PAGES * PS, tp=tp)
        pad = [np.concatenate([a, np.zeros((L, MAX_PAGES * PS - n, H, hd),
                                           a.dtype)], 1) for a in ship]
        jc = jgd.jit_import_slot_kv(J4, tp)(jc, *pad, jnp.int32(slot),
                                           jnp.int32(n))
        ref = jgd.jit_export_slot_kv(J4, tp)(jc, jnp.int32(slot))
    else:
        jc = jgd.init_paged_cache(J4, SLOTS, N_PAGES, PS,
                                  kind if quant else "fp", tp=tp)
        ptj = jnp.asarray(pt)

        def pages(a):
            out = np.zeros((L, len(pt) * PS, H, hd), a.dtype)
            out[:, :n] = a
            return out.reshape(L, len(pt), PS, H, hd)

        args = [pages(a) for a in ship]
        if quant:
            args += [np.concatenate([s, np.zeros((L, len(pt) - n_cover, H),
                                                 np.float32)], 1)
                     for s in scales]
        kv = kind if quant else "fp"
        jc = jgd.jit_import_slot_kv_paged(J4, PS, kv, tp)(
            jc, *args, ptj, jnp.int32(slot), jnp.int32(n))
        ref = jgd.jit_export_slot_kv_paged(J4, PS, kv, tp)(jc, ptj)
    for i, (r, w) in enumerate(zip(ref, want)):
        cut = n if i < 2 else n_cover
        np.testing.assert_array_equal(np.asarray(r)[:, :cut], w)


# -------------------------------------------------------- group lifetime
def _gone(pid: int) -> bool:
    """The process exited (reaped, or a zombie nobody reaped yet)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_close_leaves_no_process():
    g = ttp.DecodeGroup(("cpu",) * 3, "gloo", 60.0)
    pids = g.pids
    assert len(pids) == 2 and not any(_gone(p) for p in pids)
    assert [r["k1_launches"] for r in g.probe()] == [0, 0]
    g.close()
    assert all(_gone(p) for p in pids)
    assert [p.exitcode for p in g._procs] == [0, 0]


_ORPHAN = r"""
import os, sys
from ray_tpu_torch._private import tp
g = tp.decode_group(2, device="cpu")
print(*g.pids, flush=True)
os._exit(0)                        # no atexit: the followers are orphaned
"""


def test_followers_end_with_their_parent():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _ORPHAN], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    pids = [int(p) for p in res.stdout.split()]
    assert len(pids) == 1
    deadline = time.monotonic() + 30
    while not all(_gone(p) for p in pids):
        assert time.monotonic() < deadline, "a follower outlived its parent"
        time.sleep(0.1)


def test_unanswered_collective_raises_within_timeout():
    g = ttp.DecodeGroup(("cpu",) * 2, "gloo", 5.0)
    pids = g.pids
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed and was closed"):
        g.all_reduce(torch.ones(4))           # the follower is not in it
    assert time.monotonic() - t0 < 30
    assert g.closed and all(_gone(p) for p in pids)


def test_stale_call_refused_before_sending(torch_params):
    sh = _shards(2, "fp", torch_params)
    try:
        sh.stale = lambda: True
        with pytest.raises(ttp.GroupCallRefused):
            sh.call("decode_chunk_slots_paged", sh.params, sh.cache,
                    np.zeros(SLOTS, np.int32), np.zeros((SLOTS, 2), np.uint32),
                    np.zeros(SLOTS, bool), cfg=T4, k=1,
                    pt=np.zeros((SLOTS, MAX_PAGES), np.int32), page_size=PS)
        sh.stale = lambda: False             # the group is still in step
        toks, _, _ = sh.call(
            "decode_chunk_slots_paged", sh.params, sh.cache,
            np.zeros(SLOTS, np.int32), np.zeros((SLOTS, 2), np.uint32),
            np.ones(SLOTS, bool), cfg=T4, k=2,
            pt=np.arange(SLOTS * MAX_PAGES, dtype=np.int32).reshape(
                SLOTS, MAX_PAGES), page_size=PS)
        assert toks.shape == (SLOTS, 2)
    finally:
        sh.drop()
