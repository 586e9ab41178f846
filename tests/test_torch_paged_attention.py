"""Paged decode attention: the port's plain version against the JAX
reference's gather path AND its Pallas kernel (interpret mode on the
CPU), the int8 span merge against JAX's, and — on a machine with a card
— the CUDA kernel against the plain version.

Pools are hand-built from a numpy seed (mirroring
``tests/test_gpt_decode_kernel.py``): out-of-order and sentinel-padded
page tables, lengths that end mid-page, and garbage in pages the tables
never map.

JAX is imported inside the tests that compare with it, so that
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``
runs the card case on a machine that has no JAX.
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt_decode as tgd
from ray_tpu_torch.ops import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: F401

H, HD, PS, N_PAGES, MAX_PAGES, B = 2, 32, 8, 16, 4, 3
PT = np.full((B, MAX_PAGES), tgd.PT_SENTINEL, np.int32)
PT[0, :2] = [5, 3]            # out of order, 2 pages + sentinels
PT[1, :4] = [7, 0, 9, 2]      # full table
PT[2, :1] = [11]              # single page, ends mid-page
POS = np.array([12, 30, 4], np.int32)
LIVE = {5, 3, 7, 0, 9, 2, 11}

# Tolerances: both packages compute the same function with f32 logits
# and f32 p·v; they differ in f32 summation order only. In f32 that is
# ~1e-6 on outputs of magnitude ~1; in bf16 the output's final rounding
# may land one ulp apart (2^-7 at magnitude 1-2), hence 1e-2.
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pools(dtype: str, kv: str, seed: int = 21):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    if kv == "int8":
        k = rng.integers(-127, 128, (N_PAGES, PS, H, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (N_PAGES, PS, H, HD)).astype(np.int8)
        ks = (rng.random((N_PAGES, H)) * 0.02).astype(np.float32)
        vs = (rng.random((N_PAGES, H)) * 0.02).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((N_PAGES, PS, H, HD)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PS, H, HD)).astype(np.float32)
    return q, k, v, None, None


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import gpt_decode as jgd

    return jnp, jgd


def _jax(jax_ref, dtype, q, k, v, ks, vs, kernel):
    jnp, jgd = jax_ref
    jd = getattr(jnp, dtype)
    kv = (lambda a: jnp.asarray(a)) if k.dtype == np.int8 else \
        (lambda a: jnp.asarray(a, jd))
    out = jgd.paged_attention(
        jnp.asarray(q, jd), kv(k), kv(v), jnp.asarray(PT),
        jnp.asarray(POS), page_size=PS, kernel=kernel,
        ks=None if ks is None else jnp.asarray(ks),
        vs=None if vs is None else jnp.asarray(vs))
    return np.asarray(out, np.float32)


def _torch_inputs(dtype, q, k, v, ks, vs, device="cpu"):
    td = getattr(torch, dtype)

    def t(a, dt=None):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    kd = None if k.dtype == np.int8 else td
    return (t(q, td), t(k, kd), t(v, kd), t(PT), t(POS),
            None if ks is None else t(ks), None if vs is None else t(vs))


def _port(dtype, q, k, v, ks, vs, kernel="gather"):
    tq, tk, tv, tpt, tpos, tks, tvs = _torch_inputs(dtype, q, k, v, ks, vs)
    out = tgd.paged_attention(tq, tk, tv, tpt, tpos, page_size=PS,
                              kernel=kernel, ks=tks, vs=tvs)
    assert out.dtype == tq.dtype and out.shape == (B, 1, H, HD)
    return out.float().numpy()


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_gather_and_pallas(jax_ref, dtype, kv):
    q, k, v, ks, vs = _pools(dtype, kv)
    out = _port(dtype, q, k, v, ks, vs)
    for kernel in ("gather", "pallas"):
        np.testing.assert_allclose(
            out, _jax(jax_ref, dtype, q, k, v, ks, vs, kernel), rtol=0,
            atol=ATOL[dtype], err_msg=kernel)
    # The kernel's wrapper on CPU tensors is the plain version itself.
    assert np.array_equal(_port(dtype, q, k, v, ks, vs, kernel="cuda"), out)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_plain_ignores_unmapped_and_past_pos_garbage(kv):
    """Clobber every page the tables never map AND the tail of slot 2's
    page past pos=4: the output must not move at all."""
    q, k, v, ks, vs = _pools("float32", kv)
    base = _port("float32", q, k, v, ks, vs)
    junk = 127 if kv == "int8" else 1e4
    k2, v2 = k.copy(), v.copy()
    for p in range(N_PAGES):
        if p not in LIVE:
            k2[p] = junk
            v2[p] = junk
    k2[11, 5:] = junk
    v2[11, 5:] = junk
    assert np.array_equal(_port("float32", q, k2, v2, ks, vs), base)


def test_merge_span_int8_matches_jax(jax_ref):
    """Codes AND scales bit-equal to the reference's merge: spans that
    start mid-page over pages with old content (monotone scale, old
    codes requantized), a fresh page (reset), an inactive slot and a
    span running into an unmapped column (both dropped)."""
    rng = np.random.default_rng(5)
    n_pages, ps, S = 12, 4, 6
    codes = rng.integers(-127, 128, (n_pages, ps, H, HD)).astype(np.int8)
    scales = (rng.random((n_pages, H)) * 0.05).astype(np.float32)
    vals = rng.standard_normal((3, S, H, HD)).astype(np.float32)
    pt = np.full((3, 4), tgd.PT_SENTINEL, np.int32)
    pt[0] = [2, 7, 4, 1]
    pt[1] = [9, 3, tgd.PT_SENTINEL, tgd.PT_SENTINEL]   # runs off the map
    pt[2] = [5, 6, 8, 10]
    start = np.array([3, 6, 1], np.int32)
    count = 5
    active = np.array([True, True, False])
    jnp, jgd = jax_ref
    jc, js = jgd._merge_span_int8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(vals),
        jnp.asarray(pt), jnp.asarray(start), jnp.asarray(count),
        jnp.asarray(active), ps)
    tc, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    plan = tgd._span_plan(pt, start, count, active, ps, S, n_pages,
                          torch.device("cpu"))
    tgd._merge_span_int8(tc, ts, torch.from_numpy(vals), plan)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # Something was written, and the inactive slot's pages were not.
    assert not np.array_equal(tc.numpy(), codes)
    for p in pt[2]:
        np.testing.assert_array_equal(tc.numpy()[p], codes[p])


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    """The wrapper validates before it hands pointers to the kernel
    (checked here on CPU tensors, which the validation does not care
    about): wrong dtypes, shapes, missing scales, non-contiguous pools,
    head rows the kernel's 16-byte loads cannot tile."""
    q, k, v, ks, vs = _pools("bfloat16", "fp")
    tq, tk, tv, tpt, tpos, _, _ = _torch_inputs("bfloat16", q, k, v, ks, vs)
    assert pa._check(tq, tk, tv, tpt, tpos, PS, None, None) is False
    bad = [
        ((tq.half(), tk, tv, tpt, tpos, PS, None, None), TypeError),
        ((tq, tk.float(), tv.float(), tpt, tpos, PS, None, None), TypeError),
        ((tq[:, 0], tk, tv, tpt, tpos, PS, None, None), ValueError),
        ((tq, tk, tv, tpt.long(), tpos, PS, None, None), ValueError),
        ((tq, tk, tv, tpt, tpos[:2], PS, None, None), ValueError),
        ((tq, tk, tv, tpt, tpos, PS * 2, None, None), ValueError),
        ((tq, tk.transpose(0, 1).contiguous().transpose(0, 1), tv, tpt,
          tpos, PS, None, None), ValueError),
        ((tq, tk.to(torch.int8), tv.to(torch.int8), tpt, tpos, PS, None,
          None), ValueError),
        ((tq[..., :24].contiguous(), tk[..., :24].contiguous(),
          tv[..., :24].contiguous(), tpt, tpos, PS, None, None), ValueError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            pa._check(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype, kv):
    """The hand-written kernel against the plain version on the card, on
    the same hand-built pools (both run in the same dtypes on the same
    device; they differ in f32 summation order only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, ks, vs = _pools(dtype, kv)
    args = _torch_inputs(dtype, q, k, v, ks, vs, device="cuda")
    before = pa.launches
    out = pa.paged_attention_cuda(*args[:5], PS, args[5], args[6])
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_attention_gather(*args[:5], PS, args[5], args[6])
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0,
                               atol=ATOL[dtype])


# ---- the launch plan (CPU: shapes only) --------------------------------

def test_launch_plan_rank_columns_partition_the_table():
    """For every table width 1..300: a cluster of min(8, max_pages)
    blocks whose contiguous column ranges cover [0, max_pages) once, none
    wider than cols_per_rank, with a ring of 1..2*cols_per_rank slots and
    the shared memory the kernel's layout needs."""
    for max_pages in range(1, 301):
        for ps, hd, elem in ((16, 64, 2), (8, 32, 4), (32, 128, 1)):
            plan = pa._launch_plan(max_pages, ps, hd, elem)
            assert plan.cluster == min(pa.MAX_CLUSTER, max_pages)
            ranges = pa.rank_columns(max_pages, plan.cluster)
            cols = [j for r in ranges for j in r]
            assert cols == list(range(max_pages))
            assert max(len(r) for r in ranges) == plan.cols_per_rank
            assert 1 <= plan.stages <= 2 * plan.cols_per_rank
            assert plan.smem == pa._smem_bytes(plan.cluster,
                                               plan.cols_per_rank,
                                               plan.stages, ps, hd, elem)
            assert plan.smem <= pa._SMEM_LIMIT


@pytest.mark.parametrize("name", ["nano", "small", "medium", "1b"])
def test_launch_plan_fits_every_config(name):
    """Every CONFIGS model at its max_seq, for page sizes 8/16/32 and
    f32, bf16 and int8 pools, fits an H100 block's 227 KB, with a ring of
    at least one page slot and at most a rank's K and V pages."""
    from ray_tpu_torch.models import gpt

    cfg = gpt.CONFIGS[name]
    hd = cfg.head_dim
    for ps in (8, 16, 32):
        max_pages = -(-cfg.max_seq // ps)
        for elem in (4, 2, 1):
            plan = pa._launch_plan(max_pages, ps, hd, elem)
            assert plan.smem <= pa._SMEM_LIMIT
            assert 1 <= plan.stages <= 2 * plan.cols_per_rank


def test_launch_plan_raises_where_the_kernel_cannot_run():
    """Pages wider than a TMA box, head rows past 128, an empty table and
    a table whose rank logits outgrow shared memory are refused; the
    16,384-position table the first kernel refused is taken."""
    pa._launch_plan(1024, 16, 64, 2)
    for args in ((64, 512, 64, 2), (64, 16, 256, 2), (0, 16, 64, 2),
                 (1_000_000, 16, 64, 2)):
        with pytest.raises(ValueError):
            pa._launch_plan(*args)


# ---- the kernel on the card --------------------------------------------

# (q dtype, pool): f32 and bf16 fp pools, int8 pools under both.
KINDS = [("float32", "fp"), ("bfloat16", "fp"), ("bfloat16", "int8"),
         ("float32", "int8")]


def _edge_slots(max_pages, ps):
    """(mapped columns, pos) per slot: lengths one position before, at
    and after every rank's first and last column edge; pos = -1; a slot
    whose every column is a sentinel; live columns only in the last
    rank; pos past the table's last position (which the engine passes
    in a request's last chunk), with every column mapped and with the
    next-to-last column unmapped; every other column unmapped
    (sentinels and, for the last slot, an index past the pool)."""
    cluster = min(pa.MAX_CLUSTER, max_pages)
    ranges = pa.rank_columns(max_pages, cluster)
    full = list(range(max_pages))
    slots = []
    for c in sorted({c for r in ranges for c in (r.start, r.stop)}):
        for p in (c * ps - 1, c * ps, c * ps + 1):
            if 0 <= p < max_pages * ps:
                slots.append((full, p))
    slots += [(full, -1), ([], max_pages * ps - 1),
              (list(ranges[-1]), max_pages * ps - 1),
              (full, max_pages * ps + 3),
              ([c for c in full if c != max_pages - 2], max_pages * ps + 3),
              (full[::2], max_pages * ps - 2)]
    return slots


def _expected(kernel_args, ps, n_pages):
    """The kernel's function through the plain version: a column that is
    unmapped (sentinel or outside the pool) at or before pos is outside
    the softmax, which the plain version gets from a table holding only
    the live columns, in order, with pos cut to the count of valid
    positions; a slot with no live column is zeros."""
    q, kc, vc, pt, pos, _, ks, vs = kernel_args
    pt_np, pos_np = pt.cpu().numpy(), pos.cpu().numpy()
    pt2 = np.full_like(pt_np, tgd.PT_SENTINEL)
    pos2 = np.zeros_like(pos_np)
    empty = []
    for b, p in enumerate(pos_np):
        n_vis = 0 if p < 0 else min(p // ps + 1, pt_np.shape[1])
        live = [(pt_np[b, j], j) for j in range(n_vis)
                if 0 <= pt_np[b, j] < n_pages]
        if not live:
            empty.append(b)
            continue
        pt2[b, :len(live)] = [page for page, _ in live]
        pos2[b] = sum(min(ps, p - j * ps + 1) for _, j in live) - 1
    ref = pa.paged_attention_gather(
        q, kc, vc, torch.from_numpy(pt2).to(pt.device),
        torch.from_numpy(pos2).to(pos.device), ps, ks, vs)
    ref[empty] = 0
    return ref, empty


def _card_case(dtype, kv, hd, ps, max_pages, slots, seed, H=2):
    rng = np.random.default_rng(seed)
    B = len(slots)
    n_pages = sum(len(m) for m, _ in slots) + 4
    perm = rng.permutation(n_pages)
    pt = np.full((B, max_pages), tgd.PT_SENTINEL, np.int32)
    used = 0
    for b, (mapped, _) in enumerate(slots):
        pt[b, mapped] = perm[used:used + len(mapped)]
        used += len(mapped)
    if max_pages > 1:
        pt[-1, 1::2] = n_pages + 5          # outside the pool: unmapped
    pos = np.array([p for _, p in slots], np.int32)
    dev = "cuda"
    td = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), np.float32)
                         ).to(dev, td)
    shape = (n_pages, ps, H, hd)
    if kv == "int8":
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8)
                                   ).to(dev) for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((n_pages, H)) * 0.02)
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
    else:
        kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32)
                                   ).to(dev, td) for _ in range(2))
        ks = vs = None
    args = (q, kc, vc, torch.from_numpy(pt).to(dev),
            torch.from_numpy(pos).to(dev), ps, ks, vs)
    before = pa.launches
    out = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1        # one launch per call
    ref, empty = _expected(args, ps, n_pages)
    assert torch.isfinite(out).all()
    assert (out[empty] == 0).all()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0,
                               atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,max_pages", [
    (32, 8, 5),        # fewer columns than the portable cluster size
    (64, 16, 20),      # max_pages not a multiple of the cluster
    (128, 32, 9),      # one rank takes two columns, the others one
    (64, 8, 64),
    (128, 16, 128),    # CONFIGS["1b"] at max_seq 2048: the ring refills
])
@pytest.mark.parametrize("dtype,kv", KINDS)
def test_cuda_kernel_rank_edges(dtype, kv, hd, ps, max_pages):
    """The cluster kernel against the plain version on the card at every
    rank edge, with the slots that must give zeros and live columns in
    the last rank only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _card_case(dtype, kv, hd, ps, max_pages, _edge_slots(max_pages, ps),
               seed=hd + ps + max_pages)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv", KINDS)
def test_cuda_kernel_long_table(dtype, kv):
    """1,024 columns of 16 positions (16,384 positions, which the first
    kernel's shared-memory logits refused), full and partial lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    full = list(range(1024))
    slots = [(full, 16383), (full, 9000), (full[:3], 40), (full, -1),
             (full, 16400)]
    _card_case(dtype, kv, 64, 16, 1024, slots, seed=7)
