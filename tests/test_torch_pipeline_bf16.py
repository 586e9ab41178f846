"""The bf16 rounding of the port's tensor- and sequence-parallel training
branches held against the reference on the CPU: the pipeline's
``{pp:2,tp:2}`` (``_block_pp_tp``: each row-parallel partial cast to
bf16 before its sum over tp, as the reference's ``gpt.py:287-295``) and
Mixture-of-Experts on ``{tp:2}`` and ring ``{sp:2}``.

Nano at bf16 (``remat="none"``; the pipeline with 4 layers, the MoE
model with 4 experts, top-2, capacity factor 0.5, ``moe_aux_coef=1``),
from the reference's weights: the port's mesh step against the
reference's on the same mesh (the conftest's virtual CPU devices) on
the same weights and tokens. Summing partials in another order moves a
logit by about a bf16 ulp, in either framework, and under MoE such a
move can flip a route at a near-tie and with it the capacity slots
after it. So the bound is the reference's own gap, the larger of

- the reference's mesh run from its one-device run (how far the
  branch's own rounding moves it), and
- the port's one rank from the reference's one device (how far the two
  frameworks' bf16 arithmetic moves it with no mesh at all).

Two measures, each against that gap measured in the same test:

- the first train step's loss on ``DRAWS`` token batches: the largest
  port-vs-reference mesh gap within ``LOSS_RATIO`` times the largest
  reference gap over the same draws (a single draw says little: from
  one draw to the next each gap moves by up to two orders of
  magnitude);
- the per-token cross-entropy of one forward: its RMS port-vs-reference
  mesh difference within ``TOKEN_RATIO`` times the reference gap's.

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

B, S = 8, 32
DRAWS = 4
LOSS_RATIO = 1.5
TOKEN_RATIO = 1.25
MOE = dict(n_experts=4, expert_top_k=2, capacity_factor=0.5,
           moe_aux_coef=1.0)
# (id, mesh axes, config fields of the mesh run, config fields of both)
CASES = [
    ("pp2-tp2", {"pp": 2, "tp": 2}, dict(pp_axis="pp", num_microbatches=2),
     dict(n_layer=4)),
    ("moe-tp2", {"tp": 2}, {}, MOE),
    ("moe-sp2-ring", {"sp": 2}, dict(attn_backend="ring"), MOE),
]


def _tcfg(**kw):
    return dataclasses.replace(tgpt.CONFIGS["nano"], **{
        "dtype": torch.bfloat16, "remat": "none", "attn_backend": "xla",
        "sp_axis": "sp", **kw})


def _jcfg(**kw):
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    return dataclasses.replace(jgpt.CONFIGS["nano"], **{
        "dtype": jnp.bfloat16, "remat": "none", "attn_backend": "xla",
        "sp_axis": "sp", **kw})


def _draws():
    return [np.random.default_rng(seed).integers(0, 512, (B, S + 1))
            for seed in range(DRAWS)]


def _token_ce(logits, toks):
    """Each token's cross-entropy, from f32 logits, in numpy."""
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, toks[:, 1:, None], -1)[..., 0]


def _port_run(axes, kw, params, draws):
    """Each draw's first-step loss (from fresh weights), and draw 0's
    per-token cross-entropy of one forward, on a mesh of ``axes`` (one
    rank: ``None``). Every rank of these meshes holds all rows; a
    sequence rank returns its chunk's columns."""
    cfg = _tcfg(**kw)
    mesh = tmesh.create_mesh(axes, device="cpu") if axes else None
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    init, step, _, _ = tgpt.make_train_step(cfg, mesh, device="cpu")
    losses = [step(init(params=full), {"tokens": torch.from_numpy(t)})[1][
        "loss"].item() for t in draws]
    toks = torch.from_numpy(draws[0][:, :-1])
    if mesh is not None and "sp" in mesh.shape:
        toks = toks.chunk(mesh.shape["sp"], 1)[mesh.coords()["sp"]]
    with torch.no_grad():
        comp = full if mesh is None else tgpt.compute_params(full, mesh, cfg)
        logits = tgpt.forward(comp, toks, cfg, mesh).float().numpy()
    if mesh is not None and "sp" in mesh.shape:
        return losses, logits
    return losses, _token_ce(logits, draws[0])


def _jax_run(axes, kw, draws):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(axes, devices=jax.devices()[:n])
    cfg = _jcfg(**kw)
    init, step, _, _ = jgpt.make_train_step(cfg, mesh)
    losses = [float(step(init(jax.random.PRNGKey(0)), {
        "tokens": jnp.asarray(t)})[1]["loss"]) for t in draws]
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    logits = jax.jit(lambda p, t: jgpt.forward(p, t, cfg, mesh))(
        params, jnp.asarray(draws[0][:, :-1]))
    return losses, _token_ce(np.asarray(logits), draws[0])


@functools.lru_cache(maxsize=None)
def _one_device(kw_items):
    """The reference's weights for a config, and its one-device run and
    the port's one-rank run on them (shared by the cases of one
    config)."""
    import jax

    from ray_tpu.models import gpt as jgpt

    kw = dict(kw_items)
    tree = jax.tree_util.tree_map(np.asarray, jgpt.init_params(
        jax.random.PRNGKey(0), _jcfg(**kw)))
    params = {k: np.array(v, np.float32)
              for k, v in tgpt.params_flat(tree).items()}
    return (params, _jax_run({"dp": 1}, kw, _draws()),
            _port_run(None, kw, params, _draws()))


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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_within_the_reference_gap(request, case):
    _, axes, mesh_kw, kw = case
    params, ref_one, port_one = _one_device(tuple(sorted(kw.items())))
    draws = _draws()
    ref_mesh = _jax_run(axes, {**kw, **mesh_kw}, draws)
    n = int(np.prod(list(axes.values())))
    pool = request.getfixturevalue(f"pool{n}")
    ranks = pool.run(_port_run, axes, {**kw, **mesh_kw}, params, draws)
    for losses, _ in ranks[1:]:
        assert losses == ranks[0][0]
    if "sp" in axes:         # the sequence chunks' logits, in order
        logits = np.concatenate([r[1] for r in ranks], axis=1)
        port_mesh = (ranks[0][0], _token_ce(logits, draws[0]))
    else:
        for _, ce in ranks[1:]:
            assert np.array_equal(ce, ranks[0][1])
        port_mesh = ranks[0]

    def gap(a, b):
        return np.abs(np.subtract(a[0], b[0])).max()

    def rms(a, b):
        return float(np.sqrt(np.mean((a[1] - b[1]) ** 2)))

    ref_gap = max(gap(ref_mesh, ref_one), gap(port_one, ref_one))
    found = dict(loss_gap=gap(port_mesh, ref_mesh), ref_loss_gap=ref_gap,
                 token_rms=rms(port_mesh, ref_mesh),
                 ref_token_rms=max(rms(ref_mesh, ref_one),
                                   rms(port_one, ref_one)))
    assert found["loss_gap"] <= LOSS_RATIO * ref_gap, found
    assert found["token_rms"] <= TOKEN_RATIO * found["ref_token_rms"], found
