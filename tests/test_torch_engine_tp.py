"""The port's ``DecodeEngine(tp=N)`` held against the reference's
``DecodeEngine(tp=N)`` and against the port at tp=1, on the CPU at nano
size, f32 compute: the port's counterpart of
``tests/test_serve_engine_tp.py``. The port's ranks are gloo follower
processes (``ray_tpu_torch._private.tp``); the reference's are the 8
host devices ``tests/conftest.py`` forces.

- Token identity, stream for stream, of four concurrent requests of
  mixed lengths: flat, paged fp and paged int8 pools, greedy and seeded
  T=1.0, at tp 2 and 4, against the reference at the same tp and the
  port at tp=1; and n-gram speculative decoding the same way.
- The config plane and validation: a width that does not divide the
  heads, an MoE config and too few cards raise; ``ensure_tp`` applies on
  an unused engine, is a no-op when it matches and raises on a live one;
  ``stats()["tp"]``.
- KV handoff across widths: an N-way exporter gathers the canonical
  layout, an M-way importer scatters its own heads, the continued
  stream equals the colocated tp=1 engine's; payload digests do not
  depend on the width; a foreign layout stamp falls back to a counted
  local prefill; a reference exporter feeds a port importer.
- A driver killed mid-stream on a tp=2 engine is restarted by
  ``supervise``, every rank's pool is rebuilt, and the stream resumes
  token-identically; a call from the retired epoch is refused; a group
  that fails under a live engine, or that rank 0 leaves mid-chunk, is
  closed and replaced at the restart.

- Every ``engine.dispatch`` flight-recorder event of a tp=2 engine is
  followed by its ``shard.dispatch`` (the mesh shape and the program),
  as ``test_shard_dispatch_event_and_stats`` asks of the reference.

``test_tp_recompile_guard`` and ``test_tp_smoke_benchmark`` have no
counterpart (the port compiles no programs and has no benchmark yet).
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.batching import _EngineStream as JaxStream
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch._private import tp as ttp
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve import handoff as tho
from ray_tpu_torch.serve._stream import _EngineStream
from ray_tpu_torch.serve.engine import DecodeEngine, EngineRestartError

J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16))
POOLS = {"flat": dict(paged=False),
         "fp": dict(paged=True, page_size=8),
         "int8": dict(paged=True, page_size=8, kv_dtype="int8")}


def _cfgs(tp: int):
    """(reference cfg, port cfg): nano, widened to 4 heads where tp=4
    must divide them (as the reference's 2-to-4 handoff does)."""
    if tp <= T32.n_head:
        return J32, T32
    return (dataclasses.replace(J32, n_head=4),
            dataclasses.replace(T32, n_head=4))


_PARAMS = {}


def _params(tp: int, port: bool):
    """The reference's weights for seed 0; the port draws the same bits
    (tests/test_torch_init_params.py)."""
    jc, tc = _cfgs(tp)
    key = (tc.n_head, port)
    if key not in _PARAMS:
        _PARAMS[key] = tgpt.init_params(tc, 0, device="cpu") if port \
            else jgpt.init_params(jax.random.PRNGKey(0), jc)
    return _PARAMS[key]


def _engine(tp: int, *, port: bool = True, cfg_tp: int = 0, **kw):
    """An engine at ``tp`` on the weights of ``_cfgs(cfg_tp or tp)``."""
    jc, tc = _cfgs(cfg_tp or tp)
    kw = {**KW, **kw}
    if port:
        return DecodeEngine(_params(cfg_tp or tp, True), tc, tp=tp,
                            device="cpu", **kw)
    return JaxEngine(_params(cfg_tp or tp, False), jc, tp=tp, **kw)


def _prompt(rid: int, n: int = 7) -> np.ndarray:
    return np.random.default_rng(2000 + rid).integers(
        0, T32.vocab_size, (n,)).astype(np.int32)


def _drain(lane, port: bool = True) -> np.ndarray:
    return np.concatenate(list((_EngineStream if port else JaxStream)(lane)))


PROMPTS = [_prompt(i, n) for i, n in enumerate((5, 8, 11, 16))]
MAX_NEWS = [10, 7, 12, 3]


def _serve(eng, prompts=PROMPTS, max_news=MAX_NEWS):
    """Every request streamed from its own thread; returns the streams."""
    outs = {}
    try:
        def consume(i):
            outs[i] = np.concatenate(list(eng.stream(
                prompts[i], max_news[i], seed=100 + i)))

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert len(outs) == len(prompts)
    return [outs[i] for i in range(len(prompts))], stats


# ------------------------------------------------------- token identity
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("pool", ["flat", "fp", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_token_identity(tp, pool, temperature):
    kw = dict(POOLS[pool], temperature=temperature)
    got, stats = _serve(_engine(tp, **kw))
    assert stats["tp"] == tp and stats["completed"] == len(PROMPTS)
    one, _ = _serve(_engine(1, cfg_tp=tp, **kw))
    ref, _ = _serve(_engine(tp, port=False, **kw))
    for i in range(len(PROMPTS)):
        assert (got[i] == one[i]).all(), (i, got[i], one[i])
        assert (got[i] == ref[i]).all(), (i, got[i], ref[i])


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_decode_identity(tp):
    prompt = np.tile(np.arange(4, dtype=np.int32), 2)
    kw = dict(POOLS["fp"], spec_decode="ngram", draft_k=4)
    outs = []
    for eng, port in ((_engine(tp, **kw), True),
                      (_engine(1, cfg_tp=tp, **kw), True),
                      (_engine(tp, port=False, **kw), False)):
        try:
            outs.append(np.concatenate(list(eng.stream(prompt, 16,
                                                       seed=1))))
            assert eng.stats()["spec"]["rounds"] >= 1
        finally:
            eng.shutdown()
    assert (outs[0] == outs[1]).all() and (outs[0] == outs[2]).all(), outs


def test_shard_dispatch_event(monkeypatch):
    """Each chunk dispatch at tp=2 emits ``engine.dispatch`` then
    ``shard.dispatch`` with ``mesh=[("tp", 2)]`` and the paged chunk
    program, from rank 0's driver (events captured in place of
    ``_driver_emit``)."""
    from ray_tpu_torch.serve import engine as tengine

    seen = []
    monkeypatch.setattr(tengine, "_driver_emit",
                        lambda kind, **attrs: seen.append((kind, attrs)))
    _, stats = _serve(_engine(2, **POOLS["fp"]))
    pairs = [(k, a) for k, a in seen
             if k in ("engine.dispatch", "shard.dispatch")]
    assert stats["dispatches"] > 0
    assert [k for k, _ in pairs] == \
        ["engine.dispatch", "shard.dispatch"] * stats["dispatches"]
    for (_, disp), (_, shard) in zip(pairs[::2], pairs[1::2]):
        assert shard == {"epoch": disp["epoch"], "mesh": [("tp", 2)],
                         "program": "chunk_paged"}


# --------------------------------------------------------- config plane
def test_validation_and_config_plane():
    with pytest.raises(ValueError, match="tp=3 must divide"):
        _engine(3)                     # 3 divides neither 2 heads nor 64
    moe = dataclasses.replace(T32, n_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        DecodeEngine(tgpt.init_params(moe, 0, device="cpu"), moe, tp=2,
                     device="cpu", **KW)
    # More ranks than visible cards (this host has none).
    wide = dataclasses.replace(T32, n_head=8)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ttp.tp_validate(wide, 8, "cuda")
    eng = _engine(1, auto_start=False)
    assert eng.tp == 1 and eng._shards is None
    eng.ensure_tp(2)
    assert eng.tp == 2 and eng.stats()["tp"] == 2
    assert eng._cache["k"].shape[-2] == T32.n_head // 2
    eng.ensure_tp(2)                   # idempotent no-op
    eng.apply_config(tp=1)             # config-plane routing
    assert eng.tp == 1 and eng._shards is None
    assert eng._cache["k"].shape[-2] == T32.n_head
    eng.apply_config(tp=2, page_size=4)
    assert eng.tp == 2 and eng.page_size == 4
    eng.start()
    try:
        out = _drain(eng.submit(_prompt(9), 4))
        assert out.shape == (4,)
        with pytest.raises(ValueError, match="live"):
            eng.ensure_tp(1)
    finally:
        eng.shutdown()


def test_shutdown_and_restart_rebuild_the_followers():
    """Shutdown drops the engine's state on the followers; a later
    start loads it again, and the streams are the same."""
    eng = _engine(2, **POOLS["fp"])
    try:
        first = _drain(eng.submit(PROMPTS[1], 6))
    finally:
        eng.shutdown()
    assert eng._shards.eid is None
    eng.start()
    try:
        assert eng._shards.eid is not None
        again = _drain(eng.submit(PROMPTS[1], 6))
    finally:
        eng.shutdown()
    assert (first == again).all()


# ----------------------------------------------------- resharding handoff
@pytest.mark.parametrize("src,dst", [
    ((2, "flat"), (1, "flat")), ((1, "fp"), (2, "fp")),
    ((2, "fp"), (4, "flat")), ((4, "int8"), (2, "int8")),
    ((1, "flat"), (4, "fp"))])
def test_handoff_resharding(src, dst):
    """N-way prefill -> M-way decode, token-identical to a colocated
    tp=1 engine."""
    wide = max(src[0], dst[0])
    pre = _engine(src[0], cfg_tp=wide, role="prefill", **POOLS[src[1]])
    dec = _engine(dst[0], cfg_tp=wide, role="decode", **POOLS[dst[1]])
    ref = _engine(1, cfg_tp=wide, **POOLS[dst[1]])
    try:
        prompt = _prompt(3)
        want = _drain(ref.submit(prompt, 12, seed=9))
        desc = pre.handoff(prompt, 12, seed=9)
        out = _drain(dec.admit_prefilled(desc))
        assert (out == want).all(), (out, want)
        assert pre.stats()["handoff"]["exported"] == 1
        hd = dec.stats()["handoff"]
        assert hd["imported"] == 1 and hd["import_fallbacks"] == 0
    finally:
        for e in (pre, dec, ref):
            e.shutdown()


def test_reference_exporter_feeds_port_importer():
    """A tp=2 reference prefill engine's payload imports into a tp=4 port
    decode engine and continues as the reference's colocated engine."""
    pre = _engine(2, port=False, cfg_tp=4, role="prefill", **POOLS["fp"])
    ref = _engine(2, port=False, cfg_tp=4, **POOLS["fp"])
    dec = _engine(4, role="decode", **POOLS["fp"])
    try:
        prompt = _prompt(5)
        want = _drain(ref.submit(prompt, 10, seed=4), port=False)
        out = _drain(dec.admit_prefilled(pre.handoff(prompt, 10, seed=4)))
        assert (out == want).all(), (out, want)
        assert dec.stats()["handoff"]["import_fallbacks"] == 0
    finally:
        for e in (pre, ref, dec):
            e.shutdown()


def test_handoff_layout_mismatch_counted_fallback():
    pre = _engine(2, role="prefill", **POOLS["fp"])
    dec = _engine(2, role="decode", **POOLS["fp"])
    ref = _engine(1, **POOLS["fp"])
    try:
        prompt = _prompt(4)
        want = _drain(ref.submit(prompt, 10, seed=5))
        desc = pre.handoff(prompt, 10, seed=5)
        # A foreign exporter's mesh-local bytes: internally consistent
        # (the digest covers the stamp), wrong for this plane.
        desc["payload"]["layout"] = "tp2-local"
        desc["payload"]["digest"] = tho.payload_digest(desc["payload"])
        desc["digest"] = desc["payload"]["digest"]
        out = _drain(dec.admit_prefilled(desc))
        assert (out == want).all(), (out, want)
        hd = dec.stats()["handoff"]
        assert hd["imported"] == 0 and hd["import_fallbacks"] == 1
    finally:
        for e in (pre, dec, ref):
            e.shutdown()


@pytest.mark.parametrize("pool", ["flat", "int8"])
def test_handoff_digest_canonical_across_widths(pool):
    """The digest is a function of the canonical bytes, not of the
    exporter's width. One layer: its K/V come from column-parallel
    products over the whole d_model, bitwise the same at every width;
    deeper layers' K/V follow a row-parallel sum, whose f32 rounding
    depends on the width (the same pool contents export the same bytes
    at every depth: tests/test_torch_tp.py::test_export_is_canonical)."""
    _, cfg = _cfgs(4)
    cfg = dataclasses.replace(cfg, n_layer=1)
    params = tgpt.init_params(cfg, 0, device="cpu")
    engines = [DecodeEngine(params, cfg, tp=tp, device="cpu", role="prefill",
                            **KW, **POOLS[pool]) for tp in (1, 2, 4)]
    try:
        prompt = _prompt(6)
        descs = [e.handoff(prompt, 8, seed=2) for e in engines]
    finally:
        for e in engines:
            e.shutdown()
    assert len({d["digest"] for d in descs}) == 1
    assert all("layout" not in d["payload"] for d in descs)


# ---------------------------------------------------------- crash resume
def test_driver_kill_resume_identity():
    ref = _engine(1, temperature=1.0)
    eng = _engine(2, temperature=1.0, wedge_timeout_s=2.0)
    try:
        prompt = _prompt(8)
        want = [int(t) for t in _drain(ref.submit(prompt, 24, seed=11))]
        eng.inject_fault("driver_die", at_tokens=8)
        toks = []
        try:
            for c in eng.stream(prompt, 24, seed=11):
                toks.extend(int(t) for t in np.asarray(c).ravel())
        except EngineRestartError:
            pass
        assert 0 < len(toks) < 24, toks
        old_cache = eng._cache
        deadline = time.monotonic() + 10.0
        while eng.stats()["driver_restarts"] == 0:
            assert eng.supervise()
            assert time.monotonic() < deadline, "supervisor never restarted"
            time.sleep(0.05)
        assert eng._cache is not old_cache     # every rank's pool rebuilt
        tail = list(eng.stream(prompt, 24, seed=11, resume_from=len(toks)))
        toks.extend(int(t) for t in np.concatenate(tail))
        assert toks == want, (toks, want)
        st = eng.stats()
        assert st["driver_restarts"] == 1 and st["tp"] == 2
        # A call from the retired epoch is refused before the group
        # sees it; the group stays in step for the live driver.
        eng._driver.epoch = -1
        with pytest.raises(ttp.GroupCallRefused):
            eng._step(eng._token, eng._rngs, np.zeros(eng.slots, bool))
        del eng._driver.epoch
        assert _drain(eng.submit(prompt, 3, seed=11)).tolist() == want[:3]
    finally:
        ref.shutdown()
        eng.shutdown()


def test_failed_group_is_replaced_on_restart():
    """A group that fails under a live engine (here closed, as a
    collective timeout closes it) kills the driver; ``supervise``
    restarts it on a new group over the same devices, and the stream
    resumes token-identically."""
    ref = _engine(1, **POOLS["fp"])
    eng = _engine(2, wedge_timeout_s=2.0, **POOLS["fp"])
    try:
        prompt = _prompt(12)
        want = _drain(ref.submit(prompt, 9, seed=3))
        dead = eng._shards.group
        dead.close()
        with pytest.raises(EngineRestartError):
            _drain(eng.submit(prompt, 9, seed=3))
        deadline = time.monotonic() + 60.0
        while eng.stats()["driver_restarts"] == 0:
            assert eng.supervise()
            assert time.monotonic() < deadline, "supervisor never restarted"
            time.sleep(0.05)
        assert eng._shards.group is not dead and not eng._shards.group.closed
        assert eng._shards.group.devices == dead.devices
        assert (_drain(eng.submit(prompt, 9, seed=3)) == want).all()
    finally:
        ref.shutdown()
        eng.shutdown()


def test_rank0_fault_mid_chunk_closes_the_group(monkeypatch):
    """Rank 0 raising between two collectives of a chunk (in its
    attention call, the follower already past its own and waiting in
    the all-reduce after it) closes the group at once, so that the
    half-used group never serves another call; ``supervise`` restarts
    the driver on a new group and the stream resumes token-identically."""
    from ray_tpu_torch.models import gpt_decode as tgd

    ref = _engine(1, **POOLS["fp"])
    eng = _engine(2, wedge_timeout_s=2.0, **POOLS["fp"])
    plain = tgd.paged_attention
    fault_at = 2 * T32.n_layer + 1          # the 3rd step of 4, layer 0
    calls = [0]

    def faulty(*a, **kw):
        calls[0] += 1
        if calls[0] == fault_at:
            raise RuntimeError("injected fault on rank 0")
        return plain(*a, **kw)

    try:
        prompt = _prompt(12)
        want = [int(t) for t in _drain(ref.submit(prompt, 12, seed=3))]
        group = eng._shards.group
        monkeypatch.setattr(tgd, "paged_attention", faulty)
        toks = []
        t0 = time.monotonic()
        with pytest.raises(EngineRestartError):
            for c in eng.stream(prompt, 12, seed=3):
                toks.extend(int(t) for t in np.asarray(c).ravel())
        assert calls[0] == fault_at and group.closed
        assert not any(p.is_alive() for p in group._procs)
        # Closed by the fault, not by a collective's timeout.
        assert time.monotonic() - t0 < ttp.TIMEOUT_S / 2
        monkeypatch.setattr(tgd, "paged_attention", plain)
        deadline = time.monotonic() + 60.0
        while eng.stats()["driver_restarts"] == 0:
            assert eng.supervise()
            assert time.monotonic() < deadline, "supervisor never restarted"
            time.sleep(0.05)
        assert eng._shards.group is not group
        assert not eng._shards.group.closed
        tail = list(eng.stream(prompt, 12, seed=3, resume_from=len(toks)))
        toks.extend(int(t) for t in np.concatenate(tail))
        assert toks == want, (toks, want)
    finally:
        ref.shutdown()
        eng.shutdown()
