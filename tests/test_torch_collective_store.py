"""The port's store collective group (``ray_tpu_torch.collective``,
``backend="store"``: ``StoreGroup`` over the runtime's KV and object
store) against the reference's (``ray_tpu.collective``).

The counterparts of ``test_collective_tree.py``: tree allreduce with
O(log W) store transfers a rank, a broadcast its source puts once, small
payloads inline in the KV, generations garbage-collected, co-located
ranks in one process; every result equals numpy's, and the ``stats``
counts are those the reference's test asserts (the tree's exact counts
where the reference bounds them). Port-only: torch tensors, bf16
included, travel out of band (or inline, through the runtime's codec)
and come back as tensors; the reduction of numpy partials is the
reference's ``_combine``.
"""
import numpy as np
import pytest

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CASE_LIMIT_S = 120.0


def _spawn_group(rt, world, fn_names, payload_kbs, name, kind="numpy"):
    """``world`` actors join one store group and run each op of
    ``fn_names`` on each payload size of ``payload_kbs`` (KiB) in turn;
    per rank, ``[((dtype, result), stats after the op), ...]``, or the
    one pair for a single op and size."""
    single = isinstance(fn_names, str)
    if single:
        fn_names, payload_kbs = [fn_names], [payload_kbs]

    @rt.remote
    class Ranker:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def run(self, fn_names, payload_kbs, name, kind):
            import numpy as np
            import torch

            from ray_tpu_torch.collective import collective as C

            g = C.init_collective_group(self.world, self.rank,
                                        backend="store", group_name=name)
            outs = []
            for fn_name in fn_names:
                for payload_kb in payload_kbs:
                    x = np.full((payload_kb * 128,), float(self.rank + 1),
                                np.float64)          # payload_kb KiB
                    if kind == "bf16":
                        x = torch.from_numpy(x).to(torch.bfloat16)
                    before = dict(g.stats)
                    if fn_name == "allreduce":
                        out = g.allreduce(x)
                    elif fn_name == "broadcast":
                        out = g.broadcast(x if self.rank == 0 else None,
                                          src_rank=0)
                    elif fn_name == "allgather":
                        out = g.allgather(x)
                    else:
                        out = g.reducescatter(x, op="max")
                    if isinstance(out, torch.Tensor):
                        out = (str(out.dtype), out.float().numpy())
                    else:
                        out = (str(out.dtype), np.asarray(out))
                    outs.append((out, {k: v - before[k]
                                       for k, v in g.stats.items()}))
            return outs

    actors = [Ranker.remote(r, world) for r in range(world)]
    outs = rt.get([a.run.remote(fn_names, payload_kbs, name, kind)
                   for a in actors], timeout=120)
    return [o[0] for o in outs] if single else outs


def _inputs(world, payload_kb):
    return [np.full((payload_kb * 128,), float(r + 1)) for r in range(world)]


def test_allreduce_per_rank_transfers_logarithmic(rt_port):
    """8-rank allreduce of 64 KiB payloads: every rank moves at most
    log2(8) + 1 = 4 payloads through the store, 8 puts in all (7 reduce
    edges and 1 broadcast), and the KV carries only small ref records."""
    outs = _spawn_group(rt_port, 8, "allreduce", 64, "tree_ar8")
    want = np.sum(_inputs(8, 64), axis=0)
    for dtype, got in (o for o, _ in outs):
        assert dtype == "float64"
        np.testing.assert_array_equal(got, want)
    stats = [s for _, s in outs]
    assert sum(s["store_puts"] for s in stats) == 8, stats
    # the binomial tree's fetches: rank 0 reduces 3 partials; rank r
    # reduces one per trailing zero bit below its lowest set bit, then
    # takes the broadcast
    assert [s["store_gets"] for s in stats] == [3, 1, 2, 1, 3, 1, 2, 1]
    for s in stats:
        assert s["store_gets"] <= 4, s
        assert s["kv_bytes_in"] < 16 * 1024, s
        assert s["kv_bytes_out"] < 4 * 1024, s


def test_broadcast_src_puts_once(rt_port):
    outs = _spawn_group(rt_port, 8, "broadcast", 64, "tree_bc8")
    for _, got in (o for o, _ in outs):
        np.testing.assert_array_equal(got, np.ones(64 * 128))
    stats = [s for _, s in outs]
    assert sum(s["store_puts"] for s in stats) == 1, stats
    for i, s in enumerate(stats):
        assert s["store_gets"] == (0 if i == 0 else 1), stats
        assert s["kv_bytes_in"] < 4 * 1024, s


def test_small_payloads_stay_inline(rt_port):
    outs = _spawn_group(rt_port, 4, "allreduce", 1, "tree_inl4")  # 1 KiB
    for _, got in (o for o, _ in outs):
        np.testing.assert_array_equal(got, np.sum(_inputs(4, 1), axis=0))
    assert all(s["store_puts"] == 0 and s["store_gets"] == 0
               for _, s in outs), outs


BF16_OPS = ("allreduce", "allgather", "broadcast", "reducescatter")
BF16_KBS = (64, 1)


@pytest.fixture(scope="module")
def bf16_runs(rt_port):
    """Every op on bf16 tensors of 64 KiB (through the store) and 1 KiB
    (inline) over one group of 4 ranks."""
    return _spawn_group(rt_port, 4, BF16_OPS, BF16_KBS, "bf16", kind="bf16")


@pytest.mark.parametrize("fn_name", BF16_OPS)
def test_torch_bf16_tensors(bf16_runs, fn_name):
    """bf16 tensors through the store (out of band) and inline (the
    runtime's codec): results are bf16 tensors equal to numpy's on the
    same values (small integers: exact in bf16)."""
    for j, kb in enumerate(BF16_KBS):
        i = BF16_OPS.index(fn_name) * len(BF16_KBS) + j
        xs = _inputs(4, kb)
        for rank, per_rank in enumerate(bf16_runs):
            (dtype, got), _ = per_rank[i]
            want = {"allreduce": np.sum(xs, axis=0),
                    "allgather": np.concatenate(xs),
                    "broadcast": xs[0],
                    "reducescatter": np.split(np.max(xs, axis=0),
                                              4)[rank]}[fn_name]
            assert dtype == "torch.bfloat16"
            np.testing.assert_array_equal(got, want)
        puts = sum(per_rank[i][1]["store_puts"] for per_rank in bf16_runs)
        # a 1 KiB bf16 payload is 512 bytes: inline; 64 KiB is 32 KiB
        assert (puts == 0) == (kb == 1), (fn_name, kb, puts)


def test_many_generations_gc_bounded(rt_port):
    """Back-to-back ops cross several sync generations; held refs and
    own-slot records stay bounded by GC_LAG + SYNC_EVERY."""
    rt = rt_port

    @rt.remote
    class Looper:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def run(self, iters):
            import numpy as np

            from ray_tpu_torch.collective import collective as C

            g = C.init_collective_group(self.world, self.rank,
                                        backend="store", group_name="gcgrp")
            for _ in range(iters):
                out = g.allreduce(np.full((4096,), 1.0))  # > INLINE_MAX
                assert np.allclose(out, self.world)
            return {"slots_gens": len(g._own_slots),
                    "held_gens": len(g._held)}

    world, iters = 2, 40
    actors = [Looper.remote(r, world) for r in range(world)]
    outs = rt.get([a.run.remote(iters) for a in actors], timeout=180)
    from ray_tpu.collective.collective import StoreGroup as RefStoreGroup
    from ray_tpu_torch.collective.collective import StoreGroup

    assert (StoreGroup.GC_LAG, StoreGroup.SYNC_EVERY,
            StoreGroup.INLINE_MAX) == (RefStoreGroup.GC_LAG,
                                       RefStoreGroup.SYNC_EVERY,
                                       RefStoreGroup.INLINE_MAX)
    cap = StoreGroup.GC_LAG + StoreGroup.SYNC_EVERY
    for o in outs:
        assert o["slots_gens"] <= cap, o
        assert o["held_gens"] <= cap, o


def test_colocated_ranks_share_a_process(rt_port):
    """Two ranks of one group in one process each hold their own group;
    they communicate through the object plane; one rank leaving keeps
    the other's state and a completed send deliverable."""
    import threading

    from ray_tpu_torch.collective import collective as C

    g0 = C.init_collective_group(2, 0, backend="store", group_name="colo")
    g1 = C.init_collective_group(2, 1, backend="store", group_name="colo")
    assert g0 is not g1 and (g0.rank, g1.rank) == (0, 1)
    assert C.init_collective_group(2, 0, backend="store",
                                   group_name="colo") is g0
    with pytest.raises(ValueError, match="already exists"):
        C.init_collective_group(8, 0, backend="store", group_name="colo")
    with pytest.raises(KeyError, match="pass rank="):
        C.get_group("colo")
    assert C.get_group("colo", rank=1) is g1

    out = {}

    def run(g):
        out[g.rank] = g.allreduce(np.full((4096,), float(g.rank + 1)))

    ts = [threading.Thread(target=run, args=(g,)) for g in (g0, g1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert np.allclose(out[0], 3.0) and np.allclose(out[1], 3.0)

    g0.send(np.arange(4.0), dst_rank=1)
    C.destroy_collective_group("colo", rank=0)
    assert C.get_group("colo") is g1
    survivors = g1._core.kv_keys("__coll__/colo/", ns="collective")
    assert survivors, "rank-0 destroy wiped rank-1's keys"
    assert all(g1._is_own_key(k) for k in survivors), survivors
    assert np.allclose(g1.recv(src_rank=0), np.arange(4.0))
    C.destroy_collective_group("colo")
    with pytest.raises(KeyError, match="not initialized"):
        C.get_group("colo")
    assert not g1._core.kv_keys("__coll__/colo/", ns="collective")


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_combine_matches_reference(op):
    """The port's reduction of numpy partials is the reference's."""
    from ray_tpu.collective import collective as ref
    from ray_tpu_torch.collective import collective as port

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(64), rng.standard_normal(64)
    np.testing.assert_array_equal(port._combine(a, b, op),
                                  ref._combine(a, b, op))
    with pytest.raises(ValueError):
        port._combine(a, b, "prod")
