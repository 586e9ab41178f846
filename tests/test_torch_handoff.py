"""KV export/import and disaggregated prefill/decode in the port, held
against the reference on the CPU at nano size, f32 compute.

- ``export_slot_kv{,_paged}`` / ``import_slot_kv{,_paged}`` are bit-equal
  to the reference's on the same pool (flat, paged fp, paged int8, with
  an out-of-order, sentinel-padded page table); the port's trimmed forms
  (``length=``, uploads of the covering positions only) ship the same
  bytes and leave the same pool.
- ``build_payload`` / ``payload_digest`` are byte-equal across the two
  packages for the same request's arrays (fp and int8, flat and paged,
  bf16 as ``np.uint16`` bits against ``ml_dtypes.bfloat16``). The two
  packages' prefills are not bit-equal (XLA's and PyTorch's f32 GEMMs
  round differently), so each package's own export of a request agrees
  with the other's to f32 rounding, and the digest test feeds both
  packages the same arrays.
- Across the packages: a payload exported by either engine imports into
  the other and continues token-identical, on every flat/paged pairing
  of ``tests/test_serve_disagg.py::test_handoff_identity`` plus paged
  int8, at temperature 0 and seeded 0.8.
- The port's engine behaves as ``tests/test_serve_disagg.py`` requires of
  the reference's: identity on every pairing, ``resume_from``
  suppression, lease expiry and sweep with the pages freed, claims,
  fallbacks to a local prefill (corrupt, swapped-digest, missing or
  object-plane payloads; payloads that do not fit the engine), and the
  role gates. ``test_handoff_recompile_guard`` has no counterpart: it
  counts compiled JAX programs, and the port compiles none.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import gpt_decode as jgd
from ray_tpu.serve import handoff as jho
from ray_tpu.serve.batching import _EngineStream as JaxStream
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import gpt_decode as tgd
from ray_tpu_torch.serve import handoff as tho
from ray_tpu_torch.serve.batching import _EngineStream
from ray_tpu_torch.serve.engine import DecodeEngine
from ray_tpu_torch.serve.request import RequestDeadlineExceeded
from torch_threads import one_torch_thread  # noqa: F401

J32 = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
T32 = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32)
KW = dict(slots=2, chunk=4, max_len=64, prompt_buckets=(8, 16))
PAIRINGS = [(False, False, 0.0), (False, True, 0.0), (True, False, 0.0),
            (True, True, 0.0), (False, False, 0.8), (True, True, 0.8)]


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), J32)


@pytest.fixture(scope="module")
def torch_params():
    # The port draws the reference's weights for the same seed
    # (tests/test_torch_init_params.py): nothing is passed across.
    return tgpt.init_params(T32, 0, device="cpu")


def _prompt(rid: int, n: int = 7) -> np.ndarray:
    return np.random.default_rng(1400 + rid).integers(
        0, J32.vocab_size, (n,)).astype(np.int32)


def _engine(params, *, port: bool, **kw):
    kw = {**KW, **kw}
    if port:
        if kw.get("paged", True):
            kw.setdefault("attn_kernel", "gather")
        return DecodeEngine(params, T32, device="cpu", **kw)
    return JaxEngine(params, J32, **kw)


def _pool_kw(paged: bool, kv: str = "fp") -> dict:
    return dict(paged=paged, page_size=8, kv_dtype=kv if paged else "fp")


def _drain(lane, port: bool) -> np.ndarray:
    return np.concatenate(list((_EngineStream if port else JaxStream)(lane)))


def _ref_stream(jax_params, prompt, max_new, temperature, seed):
    """The uninterrupted stream: ``generate_chunked`` with the request's
    key (a seeded engine stream is exactly this)."""
    kw = dict(chunk=4, max_len=64)
    if temperature:
        kw.update(temperature=temperature, rng=jax.random.PRNGKey(seed))
    return np.concatenate([s[0] for s in jgd.generate_chunked(
        jax_params, prompt[None], J32, max_new, **kw)])


# ------------------------------------------------- export / import ops
L, H, HD = J32.n_layer, J32.n_head, J32.head_dim
PS, N_PAGES, SLOTS, MAX_PAGES, MAX_LEN = 8, 12, 3, 5, 40
#: Slot 1's table: out of order, then sentinels. Length 29 covers four
#: pages, the last one partly.
PT_ROW = np.array([7, 2, 10, 4, tgd.PT_SENTINEL], np.int32)
LENGTH = 29


def _random_pool(kind: str, seed: int = 0):
    """The same random pool content for both packages: (reference cache,
    port cache)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        shape = (L, SLOTS, MAX_LEN, H, HD)
    else:
        shape = (L, N_PAGES, PS, H, HD)
    if kind == "paged-int8":
        host = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.01, 0.1, (L, N_PAGES, H)
                                  ).astype(np.float32),
                "vs": rng.uniform(0.01, 0.1, (L, N_PAGES, H)
                                  ).astype(np.float32)}
    else:
        host = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    host["pos"] = np.zeros((SLOTS,), np.int32)
    jcache = {k: jnp.asarray(v) for k, v in host.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    return jcache, tcache


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["flat", "paged-fp", "paged-int8"])
def test_export_bit_equal(kind):
    jcache, tcache = _random_pool(kind)
    if kind == "flat":
        want = jgd.export_slot_kv(jcache, jnp.int32(1), cfg=J32)
        full = tgd.export_slot_kv(tcache, 1, cfg=T32)
        trim = tgd.export_slot_kv(tcache, 1, cfg=T32, length=LENGTH)
    else:
        kv = kind.split("-")[1]
        want = jgd.export_slot_kv_paged(jcache, jnp.asarray(PT_ROW),
                                        cfg=J32, page_size=PS, kv_dtype=kv)
        full = tgd.export_slot_kv_paged(tcache, PT_ROW, cfg=T32,
                                        page_size=PS, kv_dtype=kv)
        trim = tgd.export_slot_kv_paged(tcache, PT_ROW, cfg=T32,
                                        page_size=PS, kv_dtype=kv,
                                        length=LENGTH)
    assert len(full) == len(want) == len(trim)
    n_cover = -(-LENGTH // PS)
    for i, (w, f, t) in enumerate(zip(want, full, trim)):
        np.testing.assert_array_equal(f.numpy(), _np(w))
        # K/V trim to LENGTH positions, scales to the covering pages:
        # what the reference's host trim ships.
        cut = LENGTH if i < 2 else n_cover
        np.testing.assert_array_equal(t.numpy(), _np(w)[:, :cut])


@pytest.mark.parametrize("kind", ["flat", "paged-fp", "paged-int8"])
def test_import_bit_equal(kind):
    """The reference's host-padded rows/pages against the port's, given
    both padded and trimmed to the shipped positions: the same pool
    after the import, other slots' pages and sentinel columns
    untouched."""
    jcache, tcache = _random_pool(kind, seed=1)
    _, tcache2 = _random_pool(kind, seed=1)
    rng = np.random.default_rng(2)
    quant = kind == "paged-int8"
    if quant:
        ship_k = rng.integers(-127, 128, (L, LENGTH, H, HD)).astype(np.int8)
        ship_v = rng.integers(-127, 128, (L, LENGTH, H, HD)).astype(np.int8)
    else:
        ship_k = rng.standard_normal((L, LENGTH, H, HD)).astype(np.float32)
        ship_v = rng.standard_normal((L, LENGTH, H, HD)).astype(np.float32)
    if kind == "flat":
        pad = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((L, MAX_LEN - LENGTH, H, HD), a.dtype)], axis=1)
        want = jgd.import_slot_kv(jcache, pad(ship_k), pad(ship_v),
                                  jnp.int32(1), jnp.int32(LENGTH), cfg=J32)
        tgd.import_slot_kv(tcache, pad(ship_k), pad(ship_v), 1, LENGTH,
                           cfg=T32)
        tgd.import_slot_kv(tcache2, ship_k, ship_v, 1, LENGTH, cfg=T32)
    else:
        n_cover = -(-LENGTH // PS)

        def pages(a):
            out = np.zeros((L, MAX_PAGES * PS, H, HD), a.dtype)
            out[:, :LENGTH] = a
            return out.reshape(L, MAX_PAGES, PS, H, HD)

        scales = {}
        if quant:
            for name in ("ks", "vs"):
                s = np.zeros((L, MAX_PAGES, H), np.float32)
                s[:, :n_cover] = rng.uniform(0.01, 0.1, (L, n_cover, H))
                scales[name] = s
        want = jgd.import_slot_kv_paged(
            jcache, pages(ship_k), pages(ship_v), jnp.asarray(PT_ROW),
            jnp.int32(1), jnp.int32(LENGTH), cfg=J32, page_size=PS,
            ks_pages=scales.get("ks"), vs_pages=scales.get("vs"))
        tgd.import_slot_kv_paged(
            tcache, pages(ship_k), pages(ship_v), PT_ROW, 1, LENGTH,
            cfg=T32, page_size=PS, ks_pages=scales.get("ks"),
            vs_pages=scales.get("vs"))
        # Trimmed: positions only, scales of the covering pages only.
        tgd.import_slot_kv_paged(
            tcache2, ship_k, ship_v, PT_ROW, 1, LENGTH, cfg=T32,
            page_size=PS,
            ks_pages=scales["ks"][:, :n_cover] if quant else None,
            vs_pages=scales["vs"][:, :n_cover] if quant else None)
    for name in want:
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      _np(want[name]), err_msg=name)
        np.testing.assert_array_equal(tcache2[name].numpy(),
                                      _np(want[name]), err_msg=name)


def test_bf16_wire_form_round_trips():
    """A bf16 pool's K/V leave the port as ``np.uint16`` bits, the bytes
    of the reference's ``ml_dtypes.bfloat16`` arrays; the port's import
    views either form. The reference converts a ``uint16`` payload by
    value, so the reverse direction views the dtype here, in the
    test."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((L, LENGTH, H, HD)).astype(ml_dtypes.bfloat16)
    bits16 = vals.view(np.uint16)
    for form in (vals, bits16):
        t = tgd.kv_from_host(form, torch.bfloat16, torch.device("cpu"))
        (back,) = tgd.kv_to_host(t)
        assert back.dtype == np.uint16
        np.testing.assert_array_equal(back, bits16)
    # Port bits into the reference's import and back out of its export.
    cfg16 = dataclasses.replace(J32, dtype=jnp.bfloat16)
    jcache = jgd.init_paged_cache(cfg16, SLOTS, N_PAGES, PS)
    pages = np.zeros((L, MAX_PAGES * PS, H, HD), np.uint16)
    pages[:, :LENGTH] = bits16
    jcache = jgd.import_slot_kv_paged(
        jcache, pages.view(ml_dtypes.bfloat16).reshape(
            L, MAX_PAGES, PS, H, HD),
        pages.view(ml_dtypes.bfloat16).reshape(L, MAX_PAGES, PS, H, HD),
        jnp.asarray(PT_ROW), jnp.int32(1), jnp.int32(LENGTH), cfg=cfg16,
        page_size=PS)
    k, _ = jgd.export_slot_kv_paged(jcache, jnp.asarray(PT_ROW), cfg=cfg16,
                                    page_size=PS)
    np.testing.assert_array_equal(np.asarray(k)[:, :LENGTH].view(np.uint16),
                                  bits16)


# ------------------------------------------------------------ payloads
def _payload_args(payload: dict) -> dict:
    keys = ("k", "v", "prompt", "pos", "first", "rng", "seed", "max_new",
            "ks", "vs", "kv_dtype", "page_size", "layout")
    return {k: payload[k] for k in keys if k in payload}


@pytest.mark.parametrize("paged,kv", [(False, "fp"), (True, "fp"),
                                      (True, "int8")])
def test_payload_and_digest_byte_equal(jax_params, torch_params, paged,
                                       kv):
    """The same request exported by both packages' prefill engines:
    replay fields equal, K/V equal to f32 rounding (int8 codes within one
    code, scales to f32 rounding); and each package's ``build_payload``
    over the other's arrays gives byte-equal payloads and digests."""
    prompt = _prompt(0, 11)
    descs = []
    for port, params in ((False, jax_params), (True, torch_params)):
        eng = _engine(params, port=port, role="prefill",
                      temperature=0.8, **_pool_kw(paged, kv))
        try:
            descs.append(eng.handoff(prompt, 9, seed=21))
        finally:
            eng.shutdown()
    jd, td = descs
    jp, tp = jd["payload"], td["payload"]
    for name in ("prompt", "rng", "pos", "first", "seed", "max_new"):
        np.testing.assert_array_equal(np.asarray(tp[name]),
                                      np.asarray(jp[name]), err_msg=name)
    assert tp["k"].dtype == jp["k"].dtype and tp["k"].shape == jp["k"].shape
    if kv == "int8":
        for name in ("k", "v"):
            assert np.abs(tp[name].astype(int) - jp[name]).max() <= 1
        for name in ("ks", "vs"):
            np.testing.assert_allclose(tp[name], jp[name], rtol=1e-5)
        assert (tp["kv_dtype"], tp["page_size"]) == (jp["kv_dtype"],
                                                     jp["page_size"])
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(tp[name], jp[name], atol=1e-5)
    for args, digest in ((_payload_args(jp), jd["digest"]),
                         (_payload_args(tp), td["digest"])):
        a, b = jho.build_payload(**args), tho.build_payload(**args)
        assert a.keys() == b.keys()
        for name in a:
            assert np.asarray(a[name]).tobytes() == \
                np.asarray(b[name]).tobytes(), name
        assert a["digest"] == b["digest"] == digest
        assert tho.payload_digest(a) == jho.payload_digest(b) == digest
        assert tho.payload_nbytes(a) == jho.payload_nbytes(b)


def test_digest_covers_layout_and_bf16_bits():
    """A non-canonical layout stamp is hashed in both packages; a bf16
    payload hashes the same as ``np.uint16`` bits and as
    ``ml_dtypes.bfloat16``."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 5, 2, 32)).astype(ml_dtypes.bfloat16)
    args = dict(k=k, v=k, prompt=np.arange(5), pos=5, first=3,
                rng=np.array([1, 2], np.uint32), seed=7, max_new=4)
    ref = jho.build_payload(**args)
    port = tho.build_payload(**dict(args, k=k.view(np.uint16),
                                    v=k.view(np.uint16)))
    assert ref["digest"] == port["digest"]
    stamped = [m.build_payload(**args, layout="tp2") for m in (jho, tho)]
    assert stamped[0]["digest"] == stamped[1]["digest"] != ref["digest"]
    tho.verify_payload(ref)
    jho.verify_payload(port)


# ---------------------------------------------- across the packages
def _pairings():
    out = [(s, d, t, "fp") for s, d, t in PAIRINGS]
    return out + [(True, True, 0.0, "int8"), (True, True, 0.8, "int8")]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("src_paged,dst_paged,temperature,kv", _pairings())
def test_cross_package_handoff(jax_params, torch_params, direction,
                               src_paged, dst_paged, temperature, kv):
    """One package's prefill engine exports, the other's decode engine
    imports: the stream, first token included, is the uninterrupted
    stream (``generate_chunked``; for int8 pools a colocated reference
    engine of the same pool), with no fallback."""
    src_port = direction == "port_to_ref"
    prompt = _prompt(1)
    pre = _engine(torch_params if src_port else jax_params, port=src_port,
                  role="prefill", temperature=temperature,
                  **_pool_kw(src_paged, kv))
    dec = _engine(jax_params if src_port else torch_params,
                  port=not src_port, role="decode",
                  temperature=temperature, **_pool_kw(dst_paged, kv))
    try:
        desc = pre.handoff(prompt, 12, seed=9)
        out = _drain(dec.admit_prefilled(desc), port=not src_port)
        ho = dec.stats()["handoff"]
    finally:
        pre.shutdown()
        dec.shutdown()
    if kv == "int8":
        ref = _engine(jax_params, port=False, temperature=temperature,
                      **_pool_kw(True, kv))
        try:
            want = np.concatenate(list(ref.stream(prompt, 12, seed=9)))
        finally:
            ref.shutdown()
    else:
        want = _ref_stream(jax_params, prompt, 12, temperature, 9)
    np.testing.assert_array_equal(out, want)
    assert ho["imported"] == 1 and ho["import_fallbacks"] == 0


# ------------------------------------------------- the port's engine
@pytest.mark.parametrize("src_paged,dst_paged,temperature", PAIRINGS)
def test_handoff_identity(jax_params, torch_params, src_paged, dst_paged,
                          temperature):
    """``test_serve_disagg.py::test_handoff_identity`` on the port's
    engines: the decode-side stream equals the uninterrupted one and the
    counters balance."""
    pre = _engine(torch_params, port=True, role="prefill",
                  temperature=temperature, **_pool_kw(src_paged))
    dec = _engine(torch_params, port=True, role="decode",
                  temperature=temperature, **_pool_kw(dst_paged))
    try:
        prompt = _prompt(1)
        desc = pre.handoff(prompt, 12, seed=9)
        assert desc["lease_id"] and desc["digest"]
        assert desc["pos"] == prompt.shape[0]
        out = _drain(dec.admit_prefilled(desc), port=True)
        np.testing.assert_array_equal(
            out, _ref_stream(jax_params, prompt, 12, temperature, 9))
        hp, hd = pre.stats()["handoff"], dec.stats()["handoff"]
        assert hp["exported"] == 1 and hp["ship_bytes"] > 0
        assert hd["imported"] == 1 and hd["import_fallbacks"] == 0
        assert pre.stats()["role"] == "prefill"
        assert dec.stats()["role"] == "decode"
        assert pre.stats()["active_slots"] == 0
        assert hp["ship_bytes"] == tho.payload_nbytes(desc["payload"])
    finally:
        pre.shutdown()
        dec.shutdown()


def test_descriptor_keys_match_reference(jax_params, torch_params):
    """The port's handoff descriptor has the reference's keys,
    ``node_id`` (None outside a runtime) and ``deployment`` included."""
    descs = {}
    for port, params in ((False, jax_params), (True, torch_params)):
        pre = _engine(params, port=port, role="prefill",
                      deployment="ho-keys", **_pool_kw(True))
        try:
            descs[port] = pre.handoff(_prompt(1), 6, seed=2)
        finally:
            pre.shutdown()
    assert set(descs[True]) == set(descs[False])
    assert descs[True]["node_id"] is None and descs[False]["node_id"] is None
    assert descs[True]["deployment"] == descs[False]["deployment"] == \
        "ho-keys"


def test_handoff_resume_from_suppression(jax_params, torch_params):
    pre = _engine(torch_params, port=True, role="prefill")
    dec = _engine(torch_params, port=True, role="decode")
    try:
        prompt = _prompt(2)
        ref = _ref_stream(jax_params, prompt, 10, 0.0, 3)
        desc = pre.handoff(prompt, 10, seed=3)
        out = _drain(dec.admit_prefilled(desc, resume_from=4), port=True)
        np.testing.assert_array_equal(out, ref[4:])
        assert dec.stats()["resumed"] == 1
    finally:
        pre.shutdown()
        dec.shutdown()


def test_lease_expiry_sweeps_orphans(torch_params):
    """Unclaimed handoffs are reclaimed on the prefill driver's lease
    clock; the transient slots' pages are all free."""
    pre = _engine(torch_params, port=True, role="prefill", paged=True,
                  page_size=8, prefix_cache=False, handoff_ttl_s=0.3)
    try:
        base_free = pre.stats()["pages_free"]
        prompt = _prompt(4)
        for seed in (1, 2):
            pre.handoff(prompt, 8, seed=seed)
        assert pre.stats()["handoff"]["leases_outstanding"] == 2
        assert pre.stats()["pages_free"] == base_free
        for _ in range(200):
            if pre.stats()["handoff"]["leases_reclaimed"] >= 2:
                break
            time.sleep(0.05)
        ho = pre.stats()["handoff"]
        assert ho["leases_reclaimed"] == 2 and \
            ho["leases_outstanding"] == 0, ho
        assert pre.stats()["pages_free"] == base_free
    finally:
        pre.shutdown()


def test_claim_releases_lease(torch_params):
    pre = _engine(torch_params, port=True, role="prefill")
    try:
        desc = pre.handoff(_prompt(3), 5, seed=1)
        assert not pre.claim_handoff(desc["lease_id"], desc["epoch"] + 1)
        assert pre.claim_handoff(desc["lease_id"], desc["epoch"])
        assert not pre.claim_handoff(desc["lease_id"], desc["epoch"])
        ho = pre.stats()["handoff"]
        assert ho["leases_claimed"] == 1 and ho["leases_outstanding"] == 0
    finally:
        pre.shutdown()


def test_corrupt_payload_falls_back_token_identical(jax_params,
                                                    torch_params):
    """A corrupted payload, an internally consistent one whose digest is
    not the descriptor's, a missing one and an object-plane ``ref`` all
    fall back to a local prefill: the same stream, each one counted."""
    pre = _engine(torch_params, port=True, role="prefill")
    dec = _engine(torch_params, port=True, role="decode")
    try:
        prompt = _prompt(5)
        ref = _ref_stream(jax_params, prompt, 9, 0.0, 5)
        desc = pre.handoff(prompt, 9, seed=5)
        bad = dict(desc, payload=dict(desc["payload"]))
        bad["payload"]["k"] = np.array(bad["payload"]["k"])
        bad["payload"]["k"][0, 0] = 0
        swapped = dict(desc, payload=dict(bad["payload"]))
        swapped["payload"]["digest"] = tho.payload_digest(
            swapped["payload"])
        gone = {k: v for k, v in desc.items() if k != "payload"}
        remote = dict(gone, ref=object())
        for n, d in enumerate((bad, swapped, gone, remote), 1):
            out = _drain(dec.admit_prefilled(d), port=True)
            np.testing.assert_array_equal(out, ref)
            ho = dec.stats()["handoff"]
            assert ho["import_fallbacks"] == n and ho["imported"] == 0
    finally:
        pre.shutdown()
        dec.shutdown()


@pytest.mark.parametrize("case", ["kv_dtype", "page_size", "shape",
                                  "layout", "too_long"])
def test_unfit_payload_falls_back(jax_params, torch_params, case):
    """Payloads that verify but do not fit the importing engine: int8
    into an fp pool, int8 at another page size, another model's shape, a
    non-canonical layout, a position that leaves no room for
    ``max_new``."""
    src = dict(paged=True, page_size=8)
    dst = dict(paged=True, page_size=8)
    prompt, max_new = _prompt(6), 6
    params_src = torch_params
    if case == "kv_dtype":
        src["kv_dtype"] = "int8"
    elif case == "page_size":
        src["kv_dtype"] = dst["kv_dtype"] = "int8"
        dst["page_size"] = 16
    elif case == "shape":
        params_src = tgpt.init_params(
            dataclasses.replace(T32, n_layer=1), 0, device="cpu")
    pre = DecodeEngine(params_src, T32 if case != "shape" else
                       dataclasses.replace(T32, n_layer=1), device="cpu",
                       role="prefill", attn_kernel="gather",
                       **{**KW, **src})
    dec = _engine(torch_params, port=True, role="decode", **dst)
    try:
        desc = pre.handoff(prompt, max_new, seed=2)
        if case == "layout":
            args = _payload_args(desc["payload"])
            desc = dict(desc, payload=tho.build_payload(**args,
                                                        layout="tp2"))
            desc["digest"] = desc["payload"]["digest"]
        if case == "too_long":
            desc = dict(desc, max_new=64)
            want = None
        else:
            want = _ref_stream(jax_params, prompt, max_new, 0.0, 2)
        if want is None:
            with pytest.raises(ValueError, match="exceeds cache"):
                dec.admit_prefilled(desc)
        else:
            np.testing.assert_array_equal(
                _drain(dec.admit_prefilled(desc), port=True), want)
        ho = dec.stats()["handoff"]
        assert ho["import_fallbacks"] == 1 and ho["imported"] == 0
    finally:
        pre.shutdown()
        dec.shutdown()


def test_role_gates(torch_params):
    pre = _engine(torch_params, port=True, role="prefill")
    dec = _engine(torch_params, port=True, role="decode")
    try:
        prompt = _prompt(6)
        with pytest.raises(ValueError, match="prefill-role"):
            pre.submit(prompt, 4)
        with pytest.raises(ValueError, match="prefill-role"):
            pre.admit_prefilled({"prompt": prompt, "max_new": 4,
                                 "seed": 0})
        with pytest.raises(ValueError, match="decode-role"):
            dec.handoff(prompt, 4)
        with pytest.raises(ValueError, match="unknown engine role"):
            _engine(torch_params, port=True, role="router")
        with pytest.raises(ValueError, match="max_new >= 1"):
            pre.handoff(prompt, 0)
        dec.ensure_role(role="decode")          # no-op
        list(dec.stream(prompt, 3))
        with pytest.raises(ValueError, match="live engine"):
            dec.ensure_role(role="both")
        pre.handoff(prompt, 3, seed=0)
        with pytest.raises(ValueError, match="live engine"):
            pre.ensure_role(role="both")
        pre.ensure_role(handoff_ttl_s=5.0)      # the TTL may change
        assert pre._leases.ttl_s == 5.0
    finally:
        pre.shutdown()
        dec.shutdown()


def test_ensure_role_flips_a_fresh_engine(jax_params, torch_params):
    eng = _engine(torch_params, port=True)
    try:
        eng.ensure_role(role="prefill")
        desc = eng.handoff(_prompt(7), 6, seed=4)
        with pytest.raises(ValueError, match="prefill-role"):
            eng.submit(_prompt(7), 6)
        assert eng.stats()["role"] == "prefill"
    finally:
        eng.shutdown()
    both = _engine(torch_params, port=True)        # "both" imports too
    try:
        out = _drain(both.admit_prefilled(desc), port=True)
        np.testing.assert_array_equal(
            out, _ref_stream(jax_params, _prompt(7), 6, 0.0, 4))
        assert both.stats()["handoff"]["imported"] == 1
    finally:
        both.shutdown()


def test_handoff_waits_no_longer_than_its_deadline(torch_params):
    """A handoff whose driver never runs fails at its deadline."""
    pre = _engine(torch_params, port=True, role="prefill",
                  auto_start=False)
    try:
        t0 = time.time()
        with pytest.raises(RequestDeadlineExceeded):
            pre.handoff(_prompt(8), 4, deadline_s=t0 + 0.2)
        assert time.time() - t0 < 5
    finally:
        pre.shutdown()
