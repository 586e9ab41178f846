"""The port's collective groups (``ray_tpu_torch.collective``) on CPU rank
processes over gloo: every op of the reference's group surface
(``ray_tpu/collective/collective.py:33-61``) on 4 ranks (the world) and
on 2 (a mesh axis) equals numpy, through gloo's native CPU ops and
through the transport the module builds for gloo on CUDA tensors (ops
made of all-reduces and broadcasts, point-to-point staged through the
host), which the card's tests and ``chip_smoke.py`` run; the module-level
API; and a collective that one rank skips raises on the other within
the group's timeout instead of hanging.
"""
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import collective as col
from ray_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

OPS = ["allreduce_sum", "allreduce_max", "allreduce_min", "allgather",
       "reducescatter_sum", "reducescatter_max", "alltoall", "broadcast",
       "permute_1", "permute_-1", "send_recv", "barrier"]
_MESH = {}


def _mesh():
    if "m" not in _MESH:
        _MESH["m"] = tmesh.create_mesh({"dp": 2, "tp": 2}, device="cpu")
    return _MESH["m"]


def _input(rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s tensor: [n, 3] (dim 0 splits over n ranks)."""
    rng = np.random.default_rng(100 + rank)
    return rng.standard_normal((n * 2, 3)).astype(np.float32)


def _rank_op(op: str, axes, built: bool):
    """Run ``op`` on this rank's group along ``axes``; return
    (group ranks, result, ops counted as built)."""
    m = _mesh()
    g = m.group(axes)
    g.__dict__.pop("_native", None)    # the groups are cached: reset
    if built:                          # gloo's CUDA transport, on the CPU
        g._native = lambda t: False
    before = g.stats["built"]
    x = torch.from_numpy(_input(g.ranks[g.rank], g.world_size))
    name, _, arg = op.partition("_")
    if name == "allreduce":
        out = g.allreduce(x, arg)
    elif name == "allgather":
        out = g.allgather(x)
    elif name == "reducescatter":
        out = g.reducescatter(x, arg)
    elif name == "alltoall":
        out = g.alltoall(x.reshape(g.world_size, -1, 3))
    elif name == "broadcast":
        out = g.broadcast(x, src_rank=g.world_size - 1)
    elif name == "permute":
        out = g.permute(x, int(arg))
    elif name == "send":
        if g.rank == 0:
            g.send(x, dst_rank=g.world_size - 1, tag=3)
            out = x
        elif g.rank == g.world_size - 1:
            out = g.recv(tuple(x.shape), x.dtype, src_rank=0, tag=3)
        else:
            out = x
    else:
        g.barrier()
        out = x
    assert torch.equal(x, torch.from_numpy(_input(g.ranks[g.rank],
                                                  g.world_size)))
    return list(g.ranks), out.numpy(), g.stats["built"] - before


def _expected(op: str, ranks, me: int) -> np.ndarray:
    n = len(ranks)
    xs = [_input(r, n) for r in ranks]
    name, _, arg = op.partition("_")
    if name == "allreduce":
        return getattr(np, arg)(np.stack(xs), axis=0)
    if name == "allgather":
        return np.concatenate(xs)
    if name == "reducescatter":
        return np.split(getattr(np, arg)(np.stack(xs), axis=0), n)[me]
    if name == "alltoall":
        return np.stack([x.reshape(n, -1, 3)[me] for x in xs])
    if name == "broadcast":
        return xs[-1]
    if name == "permute":
        return xs[(me - int(arg)) % n]
    if name == "send" and me == n - 1:
        return xs[0]
    return xs[me]


@pytest.fixture(scope="module")
def pool4():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(4, devices=("cpu",) * 4) as pool:
        yield pool


@pytest.mark.parametrize("built", [False, True], ids=["native", "built"])
@pytest.mark.parametrize("axes", [("dp", "tp"), ("tp",)],
                         ids=["4ranks", "2ranks"])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_numpy(pool4, op, axes, built):
    res = pool4.run(_rank_op, op, axes, built)
    # Built ops are counted: on gloo's CUDA path everything but sums and
    # broadcasts, and a max/min reduce-scatter everywhere (torch has none).
    carried = op.startswith(("allreduce", "broadcast", "barrier"))
    for rank, (ranks, out, n_built) in enumerate(res):
        me = ranks.index(rank)
        np.testing.assert_allclose(out, _expected(op, ranks, me), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op} rank {me}")
        moved = op != "send_recv" or me in (0, len(ranks) - 1)
        assert n_built == int((built and not carried and moved)
                              or op == "reducescatter_max"), (op, me)


def _rank_module_api():
    """The reference's module-level API over the world and over a mesh
    axis; each result as numpy."""
    import torch.distributed as dist

    r = dist.get_rank()
    g = col.init_collective_group(4, r, backend="gloo", group_name="w",
                                  device="cpu")
    assert col.get_group("w") is g and col.get_group("w", rank=r) is g
    assert col.init_collective_group(4, r, group_name="w") is g
    x = torch.full((4,), float(r))
    out = {"allreduce": col.allreduce(x, group_name="w"),
           "allgather": col.allgather(x[:1], group_name="w"),
           "reducescatter": col.reducescatter(x, group_name="w"),
           "alltoall": col.alltoall(
               x[:, None] + 10 * torch.arange(4.0)[:, None], group_name="w"),
           "broadcast": col.broadcast(x, src_rank=2, group_name="w")}
    col.barrier(group_name="w")
    if r == 0:
        col.send(x, 3, group_name="w", tag=1)
    if r == 3:
        out["recv"] = col.recv((4,), torch.float32, 0, group_name="w",
                               tag=1)
    t = col.init_collective_group(2, _mesh().coords()["tp"], group_name="t",
                                  mesh=_mesh(), axis="tp")
    out["tp"] = t.allreduce(x)
    col.destroy_collective_group("w")
    col.destroy_collective_group("t")
    try:
        col.get_group("w")
    except KeyError:
        out["destroyed"] = True
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def test_module_api(pool4):
    res = pool4.run(_rank_module_api)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["allreduce"], np.full(4, 6.0))
        np.testing.assert_array_equal(out["allgather"], np.arange(4.0))
        np.testing.assert_array_equal(out["reducescatter"], [6.0])
        np.testing.assert_array_equal(out["alltoall"][:, 0],
                                      np.arange(4.0) + 10 * r)
        np.testing.assert_array_equal(out["broadcast"], np.full(4, 2.0))
        tp_peer = r ^ 1                      # {dp: 2, tp: 2}: tp inner
        np.testing.assert_array_equal(out["tp"],
                                      np.full(4, float(r + tp_peer)))
        assert out["destroyed"]
    np.testing.assert_array_equal(res[3]["recv"], np.zeros(4))


def test_module_api_checks_membership():
    """Without a process group there is nothing to join; a mismatched
    world size is refused."""
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        col.init_collective_group(2, 0, group_name="none")
    with pytest.raises(KeyError):
        col.get_group("never-made")


def _rank_skip(timeout_s: float):
    """Rank 0 calls an all-reduce that rank 1 never joins: it must raise
    within the group's timeout. Returns (raised, seconds waited)."""
    import torch.distributed as dist

    r = dist.get_rank()
    g = col.init_collective_group(2, r, group_name="skip",
                                  fetch_timeout_s=timeout_s, device="cpu")
    if r == 1:
        return None
    t0 = time.perf_counter()
    try:
        g.allreduce(torch.ones(3))
    except RuntimeError as e:
        return str(e)[:200], time.perf_counter() - t0
    return None, time.perf_counter() - t0


def test_skipped_collective_raises_within_timeout():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(2, devices=("cpu",) * 2) as pool:
        (msg, waited), _ = pool.run(_rank_skip, 2.0)
    assert msg is not None, "the all-reduce returned without its peer"
    assert 1.5 <= waited < 30, waited
