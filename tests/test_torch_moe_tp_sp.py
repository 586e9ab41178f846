"""Mixture-of-Experts training with tensor and sequence parallelism on CPU
rank processes over gloo against the reference's ``make_train_step`` on
the same mesh axes (the conftest's virtual CPU devices, where GSPMD sees
the whole batch), nano at f32 with 4 experts, top-2 and
``moe_aux_coef=1.0``.

At capacity factor 1.25 and at 0.5 (where tokens are dropped), on
``{tp:2}``, ring ``{sp:2}`` (two ranks), ``{dp:2,tp:2}``,
``{tp:2,ep:2}`` and Ulysses ``{dp:2,sp:2}`` (four): three steps from the
reference's weights agree with the reference's mesh step, the losses and
``moe_aux`` within ``LOSS_TOL`` and the gathered parameters within the
bound of ``tests/test_torch_train_sharded.py``.

Under sp each rank routes a sequence chunk of every row, so the global
token order (row-major) interleaves the sp ranks row by row. A case
shows that offsetting each rank's slots as if its tokens were one
contiguous block of that order gives another loss at capacity factor
0.5, while the port's ``{sp:2}`` loss is one card's. A route-level case
holds the slots of every rank of several data x sp splits to one card's,
with the all-gather played by a stand-in group.

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5
LR = tgpt.ADAMW_DEFAULTS["lr"]
B, S, STEPS, EXPERTS = 8, 32, 3, 4
FACTORS = (1.25, 0.5)
# (mesh axes, attention backend); sp meshes route sequence chunks.
TWO = [({"tp": 2}, "xla"), ({"sp": 2}, "ring")]
FOUR = [({"dp": 2, "tp": 2}, "xla"), ({"tp": 2, "ep": 2}, "xla"),
        ({"dp": 2, "sp": 2}, "ulysses")]


def _ids(m):
    if isinstance(m, tuple):
        return "-".join(f"{k}{v}" for k, v in m[0].items()) + f"-{m[1]}"
    return f"cf{m}"


def _tcfg(cf, backend="xla"):
    return dataclasses.replace(
        tgpt.CONFIGS["nano"], dtype=torch.float32, remat="none",
        attn_backend=backend, sp_axis="sp", n_experts=EXPERTS,
        expert_top_k=2, moe_aux_coef=1.0, capacity_factor=cf)


def _tokens():
    return np.random.default_rng(29).integers(0, 512, (B, S + 1))


def _rank_train(axes, backend, cf, params, toks):
    """Three steps on ``axes`` (losses, moe_aux terms, gathered f32
    params as numpy)."""
    from ray_tpu_torch.parallel import gather_tree

    mesh = tmesh.create_mesh(axes, device="cpu")
    init, step, places, _ = tgpt.make_train_step(_tcfg(cf, backend), mesh,
                                                 device="cpu")
    state = init(params={k: torch.from_numpy(v) for k, v in params.items()})
    losses, auxs = [], []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        losses.append(m["loss"].item())
        auxs.append(m["moe_aux"].item())
    full = gather_tree(state["params"], places["params"])
    return losses, auxs, {k: v.detach().numpy() for k, v in full.items()}


def _rank_sp_losses(cf, params, toks):
    """One ring ``{sp:2}`` forward's (loss, moe_aux) with the port's
    routing, then with each rank's slots offset as one contiguous block
    of the global token order (the data ranks' formula over the wider
    group)."""
    cfg = _tcfg(cf, "ring")
    mesh = tmesh.create_mesh({"sp": 2}, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    batch = {"tokens": torch.from_numpy(toks)}
    out = []
    right = tgpt._par
    for par in (right, lambda c, m: dataclasses.replace(right(c, m),
                                                        blocks=None)):
        tgpt._par = par
        try:
            with torch.no_grad():
                _, m = tgpt.loss_fn(full, batch, cfg, mesh)
        finally:
            tgpt._par = right
        out.append((m["loss"].item(), m["moe_aux"].item()))
    return out


def _jax_train(axes, backend, cf):
    """The reference's three steps on a CPU mesh of ``axes``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(axes, devices=jax.devices()[:n])
    init, step, _, _ = jgpt.make_train_step(_jax_cfg(cf, backend), mesh)
    state = init(jax.random.PRNGKey(0))
    losses, auxs = [], []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens())})
        losses.append(float(m["loss"]))
        auxs.append(float(m["moe_aux"]))
    tree = jax.tree_util.tree_map(np.asarray, state["params"])
    return losses, auxs, tgpt.params_flat(tree)


def _jax_cfg(cf, backend="xla"):
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    return dataclasses.replace(
        jgpt.CONFIGS["nano"], dtype=jnp.float32, remat="none",
        attn_backend=backend, sp_axis="sp", n_experts=EXPERTS,
        expert_top_k=2, moe_aux_coef=1.0, capacity_factor=cf)


@pytest.fixture(scope="module")
def reference():
    """The reference's nano MoE weights (numpy, the port's names)."""
    import jax

    from ray_tpu.models import gpt as jgpt

    tree = jax.tree_util.tree_map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), _jax_cfg(1.25)))
    return {k: np.array(v, np.float32)
            for k, v in tgpt.params_flat(tree).items()}


@pytest.fixture(scope="module")
def pool2():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(2, devices=("cpu",) * 2) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(4, devices=("cpu",) * 4) as pool:
        yield pool


@pytest.mark.parametrize("cf", FACTORS, ids=_ids)
@pytest.mark.parametrize("case", TWO + FOUR, ids=_ids)
def test_moe_tp_sp_steps_match_reference(request, reference, case, cf):
    axes, backend = case
    pool = request.getfixturevalue("pool4" if case in FOUR else "pool2")
    res = pool.run(_rank_train, axes, backend, cf, reference, _tokens())
    jlosses, jauxs, jparams = _jax_train(axes, backend, cf)
    for losses, auxs, got in res:
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(auxs, jauxs, rtol=0, atol=LOSS_TOL)
        for name, ref in jparams.items():
            diff = np.abs(got[name] - ref)
            assert diff.max() <= LR, (case, cf, name, diff.max())
            assert np.median(diff) <= 1e-3 * LR, (case, cf, name)
    assert res[0][0][-1] < res[0][0][0]


def test_sp_slots_follow_the_global_token_order(pool2, reference):
    """At capacity factor 0.5 a ring ``{sp:2}`` router that offsets each
    rank's slots as one contiguous block drops other pairs and gives
    another loss than one card; the port's loss and ``moe_aux`` are one
    card's. "Another" is ten times the tolerance the port is held to
    (this draw: 5.7e-4)."""
    cfg = _tcfg(0.5)
    params = {k: torch.from_numpy(v) for k, v in reference.items()}
    with torch.no_grad():
        _, one = tgpt.loss_fn(params, {"tokens": torch.from_numpy(
            _tokens())}, cfg)
    for (loss, aux), (blk_loss, _) in pool2.run(_rank_sp_losses, 0.5,
                                                reference, _tokens()):
        assert abs(loss - one["loss"].item()) <= LOSS_TOL, (loss, one)
        assert abs(aux - one["moe_aux"].item()) <= LOSS_TOL, (aux, one)
        assert abs(blk_loss - one["loss"].item()) > 10 * LOSS_TOL, \
            (blk_loss, one)


class _Gathered:
    """A stand-in routing group: rank ``rank`` of ``len(counts)``, whose
    all-gather returns every rank's per-row counts."""

    def __init__(self, counts, rank):
        self.counts, self.rank, self.world_size = counts, rank, len(counts)

    def allgather(self, x):
        assert torch.equal(x, self.counts[self.rank])
        return torch.cat(self.counts)


@pytest.mark.parametrize("split", [(2, 1), (1, 2), (2, 2), (4, 2), (1, 4)],
                         ids=lambda s: f"data{s[0]}-sp{s[1]}")
def test_route_slots_equal_one_card(split):
    """Every rank's global slots, for rows split over ``data`` ranks and
    each row's columns over ``sp`` ranks, are the slots one card gives
    the whole ``[B * S]`` token order (tight capacity, top-2)."""
    n_data, n_sp = split
    b, s, e, k, cap = 4, 8, 4, 2, 6
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(5)
                                           .standard_normal((b, s, e)) * 2),
                          -1)
    one = tmoe.route(probs.reshape(-1, e), k, cap)
    blocks = [(i // n_sp, i % n_sp) for i in range(n_data * n_sp)]
    mine = [probs.chunk(n_data, 0)[r].chunk(n_sp, 1)[c] for r, c in blocks]
    counts = []
    for p in mine:
        top = p.reshape(-1, e).sort(dim=-1, descending=True, stable=True)[1]
        hot = F.one_hot(top[:, :k].t().reshape(-1), e)
        counts.append(hot.view(k, p.shape[0], p.shape[1], e).sum(2)[None])
    got = torch.empty(k, n_data, b // n_data, n_sp, s // n_sp,
                      dtype=torch.long)
    for i, (r, c) in enumerate(blocks):
        p = mine[i]
        routes = tmoe.route(p.reshape(-1, e), k, cap, _Gathered(counts, i),
                            p.shape[0], blocks)
        got[:, r, :, c] = routes.slot.view(k, p.shape[0], p.shape[1])
        assert torch.equal(routes.keep, routes.slot < cap)
    assert torch.equal(got.view(k, -1), one.slot)
    assert not one.keep.all()
