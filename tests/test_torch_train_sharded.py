"""Sharded training (``make_train_step(cfg, mesh)``) on CPU rank processes
over gloo against the reference's ``make_train_step`` on the same mesh
axes (the conftest's virtual CPU devices), nano at f32.

Three steps from the reference's ``init_params`` weights on one global
batch, on ``{dp:2}``, ``{fsdp:2}``, ``{tp:2}`` (two ranks) and
``{dp:2,tp:2}``, ``{fsdp:2,tp:2}``, ``{fsdp:4}`` (four): the losses agree
within ``LOSS_TOL``, and the gathered parameters within the bound
``tests/test_torch_train.py`` holds the one-card step to (each within lr
of the reference, the median within 1e-3 lr), against the reference and
against the port on one rank. The flash backend (its plain versions on
the CPU) trains on ``{fsdp:2,tp:2}`` as on one rank. MoE with heads tp
does not divide, MoE in a pipeline stage, an ep axis under a dense model, an idle sp axis and
widths tp does not divide are refused before any collective (pipelines
and MoE meshes: ``test_torch_pipeline.py``, ``test_torch_moe_parallel.py``).

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
B, S, STEPS = 8, 32, 3
TWO = [{"dp": 2}, {"fsdp": 2}, {"tp": 2}]
FOUR = [{"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}, {"fsdp": 4}]


def _ids(m):
    return "-".join(f"{k}{v}" for k, v in m.items())


def _tcfg(**kw):
    return dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                               **kw)


def _tokens():
    return np.random.default_rng(17).integers(0, 512, (B, S + 1))


def _port_train(mesh, cfg, params, toks):
    """Three steps; (losses, gathered f32 params as numpy)."""
    from ray_tpu_torch.parallel import gather_tree

    init, step, places, _ = tgpt.make_train_step(cfg, mesh, device="cpu")
    state = init(params={k: torch.from_numpy(v) for k, v in params.items()})
    losses = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        losses.append(m["loss"].item())
    full = gather_tree(state["params"], places["params"])
    return losses, {k: v.detach().numpy() for k, v in full.items()}


def _rank_train(axes, cfg_kw, params, toks):
    return _port_train(tmesh.create_mesh(axes, device="cpu"),
                       _tcfg(**cfg_kw), params, toks)


@pytest.fixture(scope="module")
def reference():
    """The reference's nano weights (numpy, the port's names) and the
    port's three steps on one rank from them."""
    import jax

    from ray_tpu.models import gpt as jgpt

    tree = jax.tree_util.tree_map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), jgpt.CONFIGS["nano"]))
    params = {k: np.array(v, np.float32)
              for k, v in tgpt.params_flat(tree).items()}
    one = _port_train(None, _tcfg(), params, _tokens())
    return params, one


def _jax_train(axes):
    """The reference's three steps on a CPU mesh of ``axes``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(axes, devices=jax.devices()[:n])
    cfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32)
    init, step, _, _ = jgpt.make_train_step(cfg, mesh)
    state = init(jax.random.PRNGKey(0))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens())})
        losses.append(float(m["loss"]))
    tree = jax.tree_util.tree_map(np.asarray, state["params"])
    return losses, tgpt.params_flat(tree)


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


@pytest.mark.parametrize("axes", TWO + FOUR, ids=_ids)
def test_sharded_steps_match_reference(request, reference, axes):
    pool = request.getfixturevalue("pool4" if axes in FOUR else "pool2")
    params, (one_losses, one_params) = reference
    res = pool.run(_rank_train, axes, {}, params, _tokens())
    jlosses, jparams = _jax_train(axes)
    for losses, got in res:
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(losses, one_losses, rtol=0,
                                   atol=LOSS_TOL)
        _close(got, jparams, f"{axes} vs the reference")
        _close(got, one_params, f"{axes} vs one rank")
    assert res[0][0][-1] < res[0][0][0]


def test_flash_backend_sharded(pool4, reference):
    """``attn_backend="flash"`` on {fsdp:2, tp:2}: each rank's attention
    over its rows and heads, as one rank's."""
    params, _ = reference
    one = _port_train(None, _tcfg(attn_backend="flash"), params, _tokens())
    res = pool4.run(_rank_train, {"fsdp": 2, "tp": 2},
                    {"attn_backend": "flash"}, params, _tokens())
    for losses, got in res:
        np.testing.assert_allclose(losses, one[0], rtol=0, atol=LOSS_TOL)
        _close(got, one[1], "flash on {fsdp:2, tp:2} vs one rank")


@pytest.mark.parametrize("cfg_kw,axes,err,match", [
    (dict(n_experts=4), {"tp": 4}, ValueError, "not divisible by tp=4"),
    (dict(pp_axis="pp", n_experts=4), {"pp": 2}, NotImplementedError,
     "MoE inside a pipeline stage"),
    ({}, {"ep": 2}, ValueError, "shard nothing"),
    ({}, {"sp": 2}, ValueError, "ring or ulysses"),
    ({}, {"tp": 4}, ValueError, "not divisible by tp=4"),
    (dict(attn_backend="ring", sp_axis="sp"), {"dp": 2}, ValueError,
     "needs a mesh with the sp axis"),
    (dict(attn_backend="ulysses", sp_axis="sp", n_head=2), {"sp": 4},
     ValueError, "divisible by sp=4")], ids=lambda x: str(x))
def test_unsupported_meshes_raise(cfg_kw, axes, err, match):
    """Refused by ``make_train_step`` before any process group is
    touched (a mesh of several ranks seen from rank 0)."""
    n = int(np.prod(list(axes.values())))
    mesh = tmesh.Mesh(axes, range(n), 0, "cpu")
    with pytest.raises(err, match=match):
        tgpt.make_train_step(_tcfg(**cfg_kw), mesh)
