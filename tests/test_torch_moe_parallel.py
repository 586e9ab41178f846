"""Mixture-of-Experts training on a mesh (dp, fsdp, ep) on CPU rank
processes over gloo against the reference's ``make_train_step`` on the
same mesh axes (the conftest's virtual CPU devices, where GSPMD sees the
whole batch), nano at f32 with 4 experts, top-2 and
``moe_aux_coef=1.0``.

At capacity factor 1.25 and at 0.5 (where tokens are dropped), on
``{dp:2}``, ``{ep:2}``, ``{dp:2,ep:2}``, ``{fsdp:2,ep:2}`` and
``{ep:4}``: three steps from the reference's weights agree with the
reference's mesh step, the losses and ``moe_aux`` within ``LOSS_TOL``
and the gathered parameters within the bound of
``tests/test_torch_train_sharded.py``. The reference counts capacity
over the global batch and hands out slots over the global token order;
a case checks that a router counting only its own rank's rows would
give another loss here, and that the port's ``{dp:2}`` loss is one
card's. Experts the ep axis does not divide, MoE in a pipeline stage and
Ulysses with heads sp does not divide stay refused (MoE x tp and MoE x
sp: ``test_torch_moe_tp_sp.py``).

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5
LR = tgpt.ADAMW_DEFAULTS["lr"]
B, S, STEPS, EXPERTS = 8, 32, 3, 4
TWO = [{"dp": 2}, {"ep": 2}]
FOUR = [{"dp": 2, "ep": 2}, {"fsdp": 2, "ep": 2}, {"ep": 4}]
FACTORS = (1.25, 0.5)


def _ids(m):
    return "-".join(f"{k}{v}" for k, v in m.items()) \
        if isinstance(m, dict) else f"cf{m}"


def _tcfg(cf, **kw):
    kw = {"attn_backend": "xla", **kw}
    return dataclasses.replace(
        tgpt.CONFIGS["nano"], dtype=torch.float32, remat="none",
        n_experts=EXPERTS, expert_top_k=2, moe_aux_coef=1.0,
        capacity_factor=cf, **kw)


def _tokens():
    return np.random.default_rng(23).integers(0, 512, (B, S + 1))


def _rank_train(axes, cf, params, toks):
    """Three steps on ``axes`` (``None``: one rank); (losses, moe_aux
    terms, gathered f32 params as numpy)."""
    from ray_tpu_torch.parallel import gather_tree

    mesh = None if axes is None else tmesh.create_mesh(axes, device="cpu")
    init, step, places, _ = tgpt.make_train_step(_tcfg(cf), mesh,
                                                 device="cpu")
    state = init(params={k: torch.from_numpy(v) for k, v in params.items()})
    losses, auxs = [], []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        losses.append(m["loss"].item())
        auxs.append(m["moe_aux"].item())
    full = gather_tree(state["params"], places["params"])
    return losses, auxs, {k: v.detach().numpy() for k, v in full.items()}


def _rank_loss(axes, cf, params, toks):
    """One forward's loss and ``moe_aux`` on ``axes``, from this rank's
    rows of the batch and its compute slice of ``params``."""
    cfg = _tcfg(cf)
    mesh = tmesh.create_mesh(axes, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    rows = tuple(a for a in ("dp", "fsdp") if a in mesh.shape)
    mine = torch.from_numpy(toks).chunk(mesh.size_of(rows))[mesh.index(rows)]
    with torch.no_grad():
        _, m = tgpt.loss_fn(tgpt.compute_params(full, mesh, cfg),
                            {"tokens": mine}, cfg, mesh)
    return m["loss"].item(), m["moe_aux"].item()


def _jax_cfg(cf):
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    return dataclasses.replace(
        jgpt.CONFIGS["nano"], dtype=jnp.float32, remat="none",
        attn_backend="xla", n_experts=EXPERTS, expert_top_k=2,
        moe_aux_coef=1.0, capacity_factor=cf)


@pytest.fixture(scope="module")
def reference():
    """The reference's nano MoE weights (numpy, the port's names)."""
    import jax

    from ray_tpu.models import gpt as jgpt

    tree = jax.tree_util.tree_map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), _jax_cfg(1.25)))
    return {k: np.array(v, np.float32)
            for k, v in tgpt.params_flat(tree).items()}


def _jax_train(axes, cf):
    """The reference's three steps on a CPU mesh of ``axes``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(axes, devices=jax.devices()[:n])
    init, step, _, _ = jgpt.make_train_step(_jax_cfg(cf), mesh)
    state = init(jax.random.PRNGKey(0))
    losses, auxs = [], []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens())})
        losses.append(float(m["loss"]))
        auxs.append(float(m["moe_aux"]))
    tree = jax.tree_util.tree_map(np.asarray, state["params"])
    return losses, auxs, tgpt.params_flat(tree)


def _close(got, want, what):
    for name, ref in want.items():
        diff = np.abs(got[name] - ref)
        assert diff.max() <= LR, (what, name, diff.max())
        assert np.median(diff) <= 1e-3 * LR, (what, name, np.median(diff))


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
@pytest.mark.parametrize("axes", TWO + FOUR, ids=_ids)
def test_moe_steps_match_reference(request, reference, axes, cf):
    pool = request.getfixturevalue("pool4" if axes in FOUR else "pool2")
    res = pool.run(_rank_train, axes, cf, reference, _tokens())
    jlosses, jauxs, jparams = _jax_train(axes, cf)
    for losses, auxs, got in res:
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(auxs, jauxs, rtol=0, atol=LOSS_TOL)
        _close(got, jparams, f"{axes} at capacity factor {cf}")
    assert res[0][0][-1] < res[0][0][0]


def test_capacity_counts_the_global_batch(pool2, reference):
    """At capacity factor 0.5 a router that counts capacity over its own
    rank's rows (each half of the batch alone, as two one-card forwards)
    drops other tokens and gives another loss; the port's ``{dp:2}``
    loss and ``moe_aux`` are one card's on the whole batch."""
    cfg = _tcfg(0.5)
    params = {k: torch.from_numpy(v) for k, v in reference.items()}
    toks = torch.from_numpy(_tokens())
    with torch.no_grad():
        _, whole = tgpt.loss_fn(params, {"tokens": toks}, cfg)
        halves = [tgpt.loss_fn(params, {"tokens": t}, cfg)[1]["loss"]
                  for t in toks.chunk(2)]
    local = float(sum(halves)) / 2
    assert abs(local - whole["loss"].item()) > 1e-3, (local, whole)
    for loss, aux in pool2.run(_rank_loss, {"dp": 2}, 0.5, reference,
                               _tokens()):
        assert abs(loss - whole["loss"].item()) <= 1e-6, (loss, whole)
        assert abs(aux - whole["moe_aux"].item()) <= 1e-6, (aux, whole)


@pytest.mark.parametrize("axes,kw,err,match", [
    pytest.param({"ep": 3}, {}, ValueError,
                 "n_experts=4 not divisible by ep=3",
                 id="{'ep': 3}-n_experts=4 not divisible by ep=3"),
    pytest.param({"pp": 2}, {"pp_axis": "pp"}, NotImplementedError,
                 "MoE inside a pipeline stage", id="pp2-moe-in-a-stage"),
    pytest.param({"tp": 2, "sp": 2}, {"attn_backend": "ulysses"},
                 ValueError, "ulysses needs the 1 heads",
                 id="tp2-sp2-ulysses-heads")])
def test_moe_unported_meshes_raise(axes, kw, err, match):
    """What the reference refuses stays refused: experts the ep axis does
    not divide, MoE in a pipeline stage, and Ulysses with heads sp does
    not divide. MoE x tp and MoE x sp train (``test_torch_moe_tp_sp.py``)."""
    n = int(np.prod(list(axes.values())))
    mesh = tmesh.Mesh(axes, range(n), 0, "cpu")
    with pytest.raises(err, match=match):
        tgpt.make_train_step(_tcfg(1.25, sp_axis="sp", **kw), mesh)
