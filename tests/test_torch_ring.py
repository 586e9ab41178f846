"""Ring and Ulysses attention (``ray_tpu_torch.ops.ring_attention``) on CPU
rank processes over gloo against the reference's
(``ray_tpu/ops/ring_attention.py`` under ``shard_map`` on the conftest's
virtual CPU devices) and against the port's ``_attention_xla``: outputs
and the gradients of q, k and v, at 2 and 4 ranks, causal and not, f32
and bf16; and nano training on ``{dp:2, sp:2}`` with each, three steps
against the reference's ``make_train_step`` on the same mesh (mirroring
``tests/test_ops_ring.py``).

JAX is imported inside the tests: the rank processes import this module
to find their functions and need only torch.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import ring_attention as tra
from ray_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

B, S, H, HD = 2, 64, 4, 16
# f32: against the port's own einsum attention the same arithmetic in
# another order, ~1e-6 (1e-5); against the reference 1e-4, the bound the
# reference's own ring test holds its ring to its einsum attention at
# (tests/test_ops_ring.py): one run in this suite measured 5.2e-5 there,
# others 4e-7. bf16: both packages round q·scale, p and the output to
# bf16 at the same points; sums of f32 terms in another order can move a
# rounding by one bf16 ulp (2^-8 relative), ~4e-3 at |x| ~ 1, so 2e-2
# absolute on outputs and grads of size ~1-3.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
REF_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL = 1e-5
LR = tgpt.ADAMW_DEFAULTS["lr"]


def _inputs(dtype: str):
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((B, S, H, HD)).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do


def _rank_attention(name, causal, dtype):
    """This rank's chunk through ``name`` over the world (the sp axis);
    returns (out, dq, dk, dv) chunks as f32 numpy."""
    mesh = tmesh.create_mesh({"sp": -1}, device="cpu")
    g = mesh.group("sp")
    n, r = g.world_size, g.rank
    td = getattr(torch, dtype)
    chunks = [torch.from_numpy(x).chunk(n, dim=1)[r].to(td).requires_grad_()
              for x in _inputs(dtype)[:3]]
    do = torch.from_numpy(_inputs(dtype)[3]).chunk(n, dim=1)[r].to(td)
    fn = getattr(tra, name)
    out = fn(*chunks, group=g, causal=causal)
    out.backward(do)
    return [t.detach().float().numpy() for t in
            (out, *(c.grad for c in chunks))]


def _jax_attention(name, n, causal, dtype):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu._private.jax_compat import shard_map
    from ray_tpu.ops import ring_attention as jra
    from ray_tpu.parallel import create_mesh

    mesh = create_mesh({"sp": n}, devices=jax.devices()[:n])
    spec = P(None, "sp", None, None)
    fn = shard_map(functools.partial(getattr(jra, name), axis_name="sp",
                                     causal=causal, axis_size=n),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    jd = getattr(jnp, dtype)
    q, k, v, do = (jnp.asarray(x).astype(jd) for x in _inputs(dtype))
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in
            (out, *vjp(do))]


@pytest.fixture(scope="module")
def pools():
    from ray_tpu_torch._private.ranks import RankPool

    with RankPool(2, devices=("cpu",) * 2) as two, \
            RankPool(4, devices=("cpu",) * 4) as four:
        yield {2: two, 4: four}


def _einsum_attention(q, k, v, causal):
    """Softmax attention with autograd, causal or not, in f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool).tril()
        s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _gathered(pool, name, causal, dtype):
    res = pool.run(_rank_attention, name, causal, dtype)
    return [np.concatenate([r[i] for r in res], axis=1) for i in range(4)]


@pytest.mark.parametrize("n,dtype", [(4, "float32"), (2, "bfloat16")],
                         ids=str)
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sp_attention_matches_reference(pools, name, n, dtype):
    """Causal outputs and q/k/v gradients against the reference's under
    ``shard_map`` on the same number of devices."""
    got = _gathered(pools[n], name, True, dtype)
    want = _jax_attention(name, n, True, dtype)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=REF_TOL[dtype],
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("n,causal", [(2, True), (2, False), (4, False)],
                         ids=str)
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sp_attention_matches_one_device(pools, name, n, causal):
    """Outputs and gradients against one device's attention: the port's
    ``_attention_xla`` (causal) or the plain softmax (not)."""
    got = _gathered(pools[n], name, causal, "float32")
    cfg = dataclasses.replace(tgpt.CONFIGS["nano"], n_head=H,
                              d_model=H * HD)
    q, k, v, do = (torch.from_numpy(x).requires_grad_()
                   for x in _inputs("float32"))
    ref = tgpt._attention_xla(q, k, v, cfg) if causal else \
        _einsum_attention(q, k, v, False)
    ref.backward(do.detach())
    for what, a, b in zip(("out", "dq", "dk", "dv"), got,
                          (ref, q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0,
                                   atol=TOL["float32"],
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_one_rank_is_local_attention(name):
    """No group (one rank): the same function as the einsum attention."""
    cfg = dataclasses.replace(tgpt.CONFIGS["nano"], n_head=H,
                              d_model=H * HD)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("float32"))
    got = getattr(tra, name)(q, k, v, sm_scale=1 / math.sqrt(HD))
    np.testing.assert_allclose(got.numpy(),
                               tgpt._attention_xla(q, k, v, cfg).numpy(),
                               rtol=0, atol=1e-5)


def _rank_sp_train(backend, params, toks):
    from ray_tpu_torch.parallel import gather_tree

    cfg = dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                              attn_backend=backend, sp_axis="sp")
    mesh = tmesh.create_mesh({"dp": 2, "sp": 2}, device="cpu")
    init, step, places, _ = tgpt.make_train_step(cfg, mesh)
    state = init(params={k: torch.from_numpy(v) for k, v in params.items()})
    losses = []
    for _ in range(3):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        losses.append(m["loss"].item())
    full = gather_tree(state["params"], places["params"])
    return losses, {k: v.detach().numpy() for k, v in full.items()}


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_gpt_trains_on_dp_sp_mesh(pools, backend):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import create_mesh

    jcfg = dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32,
                               attn_backend=backend, sp_axis="sp")
    mesh = create_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:4])
    init, step, _, _ = jgpt.make_train_step(jcfg, mesh)
    jstate = init(jax.random.PRNGKey(0))
    params = {k: np.array(v, np.float32) for k, v in tgpt.params_flat(
        jax.tree_util.tree_map(np.asarray, jstate["params"])).items()}
    toks = np.random.default_rng(2).integers(0, 512, (4, 65))
    jlosses = []
    for _ in range(3):
        jstate, m = step(jstate, {"tokens": jnp.asarray(toks)})
        jlosses.append(float(m["loss"]))
    want = tgpt.params_flat(jax.tree_util.tree_map(np.asarray,
                                                   jstate["params"]))
    for losses, got in pools[4].run(_rank_sp_train, backend, params, toks):
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
        assert losses[-1] < losses[0]
        for name, ref in want.items():
            diff = np.abs(got[name] - ref)
            assert diff.max() <= LR and np.median(diff) <= 1e-3 * LR, name
