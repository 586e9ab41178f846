"""Pipeline-parallel training (``make_train_step`` with ``cfg.pp_axis``)
on CPU rank processes over gloo against the reference's pipeline on the
same mesh axes (the conftest's virtual CPU devices), nano at f32 with 4
layers, ``remat="none"``, xla attention.

On ``{pp:2}``, ``{pp:4}``, ``{dp:2,pp:2}``, ``{pp:2,tp:2}`` and
``{pp:2,sp:2}``: ``forward`` (every pp rank's logits, each rank's rows
and sequence chunk) equals the reference's mesh forward within
``FWD_TOL``; three steps from the reference's weights agree with the
reference's mesh step and with the port's one-rank step, the losses
within ``LOSS_TOL`` and the gathered parameters within the bound of
``tests/test_torch_train_sharded.py``. The flash backend (its plain
versions here) trains on ``{pp:2}`` as on one rank. The reference's
refusals (a tp or sp axis the block does not handle, pp x tp x sp, MoE
in a stage, rows the microbatches do not divide) raise before any
collective.

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
FWD_TOL = 1e-5
LR = tgpt.ADAMW_DEFAULTS["lr"]
B, S, STEPS, LAYERS = 8, 32, 3, 4
MESHES = [({"pp": 2}, {}), ({"pp": 4}, {}), ({"dp": 2, "pp": 2}, {}),
          ({"pp": 2, "tp": 2}, {}), ({"pp": 2, "sp": 2}, {"sp_axis": "sp"})]


def _ids(m):
    return "-".join(f"{k}{v}" for k, v in m.items())


def _tcfg(**kw):
    return dataclasses.replace(tgpt.CONFIGS["nano"], **{
        "dtype": torch.float32, "n_layer": LAYERS, "remat": "none",
        "attn_backend": "xla", **kw})


def _pp(**kw):
    return dict(pp_axis="pp", num_microbatches=2, **kw)


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


def _rank_forward(axes, cfg_kw, params, toks):
    """This rank's logits of its rows (and sequence chunk) of
    ``toks[:, :-1]``."""
    cfg = _tcfg(**cfg_kw)
    mesh = tmesh.create_mesh(axes, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    rows = tuple(a for a in ("dp", "fsdp") if a in mesh.shape)
    tk = torch.from_numpy(toks[:, :-1]).chunk(
        mesh.size_of(rows))[mesh.index(rows)]
    if cfg.sp_axis in mesh.shape:
        tk = tk.chunk(mesh.shape["sp"], dim=1)[mesh.coords()["sp"]]
    with torch.no_grad():
        return tgpt.forward(tgpt.compute_params(full, mesh, cfg), tk, cfg,
                            mesh).numpy()


def _jax_cfg(**kw):
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    return dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32,
                               n_layer=LAYERS, remat="none",
                               attn_backend="xla", **kw)


def _jax_mesh(axes):
    import jax

    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def reference():
    """The reference's 4-layer nano weights (numpy, the port's names)
    and the port's three steps on one rank from them."""
    import jax

    from ray_tpu.models import gpt as jgpt

    tree = jax.tree_util.tree_map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), _jax_cfg()))
    params = {k: np.array(v, np.float32)
              for k, v in tgpt.params_flat(tree).items()}
    one = _port_train(None, _tcfg(), params, _tokens())
    return params, one


def _jax_forward(axes, kw):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    cfg = _jax_cfg(**kw)
    mesh = _jax_mesh(axes)
    params = jgpt.init_params(jax.random.PRNGKey(0), _jax_cfg())
    out = jax.jit(lambda p, t: jgpt.forward(p, t, cfg, mesh))(
        params, jnp.asarray(_tokens()[:, :-1]))
    return np.asarray(out)


def _jax_train(axes, kw):
    """The reference's three steps on a CPU mesh of ``axes``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    init, step, _, _ = jgpt.make_train_step(_jax_cfg(**kw), _jax_mesh(axes))
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


def _pool(request, axes):
    n = int(np.prod(list(axes.values())))
    return request.getfixturevalue(f"pool{n}")


@pytest.mark.parametrize("axes,kw", MESHES, ids=lambda x: _ids(x) or "-")
def test_pipeline_forward_matches_reference(request, reference, axes, kw):
    params, _ = reference
    outs = _pool(request, axes).run(_rank_forward, axes, _pp(**kw), params,
                                    _tokens())
    want = _jax_forward(axes, _pp(**kw))
    mesh = tmesh.Mesh({a: axes[a] for a in tmesh.AXIS_ORDER if a in axes},
                      range(len(outs)), 0, "cpu")      # create_mesh's order
    for r, got in enumerate(outs):
        c = mesh.coords(r)
        b = got.shape[0] * c.get("dp", 0)
        s = got.shape[1] * c.get("sp", 0)
        np.testing.assert_allclose(
            got, want[b:b + got.shape[0], s:s + got.shape[1]], rtol=0,
            atol=FWD_TOL, err_msg=f"rank {r} {c}")


@pytest.mark.parametrize("axes,kw", MESHES, ids=lambda x: _ids(x) or "-")
def test_pipeline_steps_match_reference(request, reference, axes, kw):
    params, (one_losses, one_params) = reference
    res = _pool(request, axes).run(_rank_train, axes, _pp(**kw), params,
                                   _tokens())
    jlosses, jparams = _jax_train(axes, _pp(**kw))
    for losses, got in res:
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(losses, one_losses, rtol=0,
                                   atol=LOSS_TOL)
        _close(got, jparams, f"{axes} vs the reference")
        _close(got, one_params, f"{axes} vs one rank")
    assert res[0][0][-1] < res[0][0][0]


def test_pipeline_flash_backend(pool2, reference):
    """``attn_backend="flash"`` on {pp:2}: every stage's attention is the
    flash pair (its plain versions on the CPU), as on one rank; the
    default microbatch count (2 * pp)."""
    params, _ = reference
    one = _port_train(None, _tcfg(attn_backend="flash"), params, _tokens())
    res = pool2.run(_rank_train, {"pp": 2},
                    {"attn_backend": "flash", "pp_axis": "pp"}, params,
                    _tokens())
    for losses, got in res:
        np.testing.assert_allclose(losses, one[0], rtol=0, atol=LOSS_TOL)
        _close(got, one[1], "flash on {pp:2} vs one rank")


@pytest.mark.parametrize("axes,kw,match", [
    ({"pp": 2, "tp": 2}, {}, "tp-aware"),
    ({"pp": 2, "sp": 2}, {}, "sp-aware"),
    ({"dp": 2}, {}, "no 'pp' axis"),
    ({"pp": 2}, {"num_microbatches": 3},
     "per-shard batch 4 not divisible by num_microbatches=3")],
    ids=lambda x: str(x))
def test_pipeline_apply_rejections(axes, kw, match):
    """``pipeline_apply``'s refusals (``pipeline.py:72-83``, ``:97-100``;
    the reference's ``tests/test_parallel_pp_ep.py:59-76``,
    ``tests/test_parallel_pp_sp.py:58-66``), raised before any process
    group is touched."""
    from ray_tpu_torch.parallel import pipeline_apply

    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError, match=match):
        pipeline_apply(lambda a, p: a, {}, torch.zeros(4, 8, 16),
                       mesh=tmesh.Mesh(axes, range(n), 0, "cpu"), **kw)


@pytest.mark.parametrize("cfg_kw,axes,err,match", [
    ({}, {"pp": 2, "sp": 2}, ValueError, "sp-aware"),
    (dict(sp_axis="sp"), {"pp": 2, "tp": 2, "sp": 2}, NotImplementedError,
     "pick two"),
    (dict(n_experts=4), {"pp": 2}, NotImplementedError,
     "MoE inside a pipeline stage"),
    ({}, {"pp": 2, "tp": 4}, ValueError, "not divisible by tp=4"),
    (dict(n_layer=3), {"pp": 2}, ValueError, "n_layer=3 not divisible"),
    ({}, {"pp": 2, "ep": 2}, ValueError, "shard nothing")],
    ids=lambda x: str(x))
def test_pipeline_rejections(cfg_kw, axes, err, match):
    """The pipeline branch's refusals (``gpt.py:377-394``;
    ``tests/test_parallel_pp_sp.py:69-77``), MoE in a stage included,
    raised by ``make_train_step`` before any process group is touched."""
    n = int(np.prod(list(axes.values())))
    mesh = tmesh.Mesh(axes, range(n), 0, "cpu")
    with pytest.raises(err, match=match):
        tgpt.make_train_step(_tcfg(pp_axis="pp", **cfg_kw), mesh)
