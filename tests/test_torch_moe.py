"""The port's Mixture-of-Experts FFN (``ray_tpu_torch.models.moe``) and
MoE GPT training (``ray_tpu_torch.models.gpt`` with ``n_experts > 0``)
against the JAX reference on the CPU, with inputs made from numpy seeds.

``capacity`` and the dense ``top_k_gating`` are equal (the one-hot
tensors exactly; ties, with a zero router's equal probabilities, go to
the lower expert index as ``lax.top_k`` sends them; overflow drops the
same pairs). ``moe_ffn`` routes by index where the reference multiplies
one-hot tensors, and holds y, aux and the gradients of x, router, w_up
and w_down to the reference at f32 (atol 1e-5) and bf16 (``BF16_ATOL``).
Then the nano MoE model (``n_experts=4, expert_top_k=2``): logits,
loss and ``moe_aux`` of ``forward``/``loss_fn``, gradients, and three
``make_train_step`` steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import moe as jmoe
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import moe as tmoe
from torch_threads import one_torch_thread  # noqa: F401

F32_ATOL = 1e-5
# bf16: the two frameworks round GELU's inner terms and the expert
# products' partial sums at different places, so an output may differ by
# one bf16 ulp of its value; |y| < 4 here, where an ulp is at most 2**-6,
# and the bound is two of those (measured 7.8e-3).
BF16_ATOL = 2.0 ** -6 * 2
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4

NANO_MOE = dict(n_experts=4, expert_top_k=2)


def _inputs(seed, B=2, S=16, d=64, E=4, f=256, router_scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)).astype(np.float32),
            (rng.standard_normal((d, E)) * router_scale).astype(np.float32),
            (rng.standard_normal((E, d, f)) / 8).astype(np.float32),
            (rng.standard_normal((E, f, d)) / 16).astype(np.float32))


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_capacity_equal(top_k):
    for tokens in (1, 3, 7, 8, 16, 17, 100, 1024, 32768):
        for E in (1, 4, 8, 64):
            for cf in (0.25, 1.0, 1.25, 2.0):
                assert tmoe.capacity(tokens, E, top_k, cf) == \
                    jmoe.capacity(tokens, E, top_k, cf)


def _probs(case):
    rng = np.random.default_rng(7)
    if case == "random":
        logits = rng.standard_normal((48, 4)).astype(np.float32)
        return jax.nn.softmax(jnp.asarray(logits)), 2, 16
    if case == "overflow":
        # tests/test_parallel_pp_ep.py::test_moe_capacity_drops_overflow
        p = jnp.tile(jnp.asarray([[0.97, 0.01, 0.01, 0.01]]), (64, 1))
        return p, 1, jmoe.capacity(64, 4, 1, 0.25)
    if case == "zero_router":
        # Every probability equal: top-2 is experts 0 and 1 for all 20
        # tokens, and both overflow a capacity of 8.
        return jax.nn.softmax(jnp.zeros((20, 4))), 2, 8
    if case == "top3_tight":
        logits = (rng.standard_normal((40, 8)) * 3).astype(np.float32)
        return jax.nn.softmax(jnp.asarray(logits)), 3, 8
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "overflow", "zero_router",
                                  "top3_tight"])
def test_top_k_gating_equal(case):
    probs, k, cap = _probs(case)
    jd, jc, ja = jmoe.top_k_gating(probs, k, cap)
    td, tc, ta = tmoe.top_k_gating(torch.from_numpy(np.array(probs)),
                                   k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # The means over tokens sum in another order: a few f32 ulps.
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    if case in ("overflow", "zero_router", "top3_tight"):
        assert td.sum().item() < probs.shape[0] * k    # pairs dropped


def test_route_matches_dense_form():
    """``route``'s pairs are the dense tensors' nonzeros: the kept pairs
    at (token, expert, slot), each slot of an expert used once."""
    probs, k, cap = _probs("top3_tight")
    t = torch.from_numpy(np.array(probs))
    r = tmoe.route(t, k, cap)
    dispatch, combine, _ = tmoe.top_k_gating(t, k, cap)
    tok = torch.arange(t.shape[0]).expand(k, -1)
    at = (tok[r.keep], r.expert[r.keep], r.slot[r.keep])
    assert dispatch[at].eq(1).all() and dispatch.sum() == len(at[0])
    assert torch.equal(combine[at], r.gate[r.keep])
    flat = r.expert[r.keep] * cap + r.slot[r.keep]
    assert flat.unique().numel() == flat.numel()


def test_top_k_gating_grads_equal():
    """Gradients reach ``probs`` through the gates and the aux term
    alike."""
    probs, k, cap = _probs("random")
    w = np.random.default_rng(3).standard_normal(
        (probs.shape[0], 4, cap)).astype(np.float32)

    def jf(p):
        _, c, a = jmoe.top_k_gating(p, k, cap)
        return jnp.sum(c * w) + a

    want = np.asarray(jax.grad(jf)(probs))
    tp = torch.tensor(np.array(probs), requires_grad=True)
    _, c, a = tmoe.top_k_gating(tp, k, cap)
    ((c * torch.from_numpy(w)).sum() + a).backward()
    np.testing.assert_allclose(tp.grad.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ moe_ffn
def _both_moe(x, r, wu, wd, cf, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    kw = dict(top_k=2, capacity_factor=cf)
    yj, aj = jmoe.moe_ffn(jnp.asarray(x).astype(jdt), jnp.asarray(r),
                          jnp.asarray(wu), jnp.asarray(wd), dtype=jdt, **kw)
    yt, at = tmoe.moe_ffn(torch.from_numpy(x).to(dtype), torch.from_numpy(r),
                          torch.from_numpy(wu), torch.from_numpy(wd),
                          dtype=dtype, **kw)
    return (np.asarray(yj.astype(jnp.float32)), float(aj),
            yt.float().numpy(), at.item(), yt.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_ffn_equal(dtype, cf):
    """y and aux, with every token kept (cf 1.25) and with a capacity of
    8 for 32 tokens' 64 pairs (cf 0.25: drops)."""
    x, r, wu, wd = _inputs(11)
    yj, aj, yt, at, ydt = _both_moe(x, r, wu, wd, cf, dtype)
    assert ydt == dtype
    tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(yt, yj, rtol=0, atol=tol)
    assert abs(at - aj) < 1e-6
    kept = tmoe.route(torch.softmax(torch.from_numpy(x).reshape(-1, 64)
                                    @ torch.from_numpy(r), -1), 2,
                      tmoe.capacity(32, 4, 2, cf)).keep
    assert bool(kept.all()) == (cf == 1.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_grads_equal(dtype):
    """``jax.grad`` of ``sum(y * g) + aux`` against autograd, for x,
    router, w_up and w_down, with drops (cf 0.5). f32 within 1e-5; bf16
    within ``BF16_ATOL`` relative to each gradient's largest entry (the
    bf16 forward's rounding reaches the gradient)."""
    x, r, wu, wd = _inputs(12)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]

    def jf(x, r, wu, wd):
        y, a = jmoe.moe_ffn(x.astype(jdt), r, wu, wd, top_k=2,
                            capacity_factor=0.5, dtype=jdt)
        return jnp.sum(y.astype(jnp.float32) * g) + a

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, r, wu, wd)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, r, wu, wd)]
    y, a = tmoe.moe_ffn(ts[0].to(dtype), *ts[1:], top_k=2,
                        capacity_factor=0.5, dtype=dtype)
    ((y.float() * torch.from_numpy(g)).sum() + a).backward()
    for name, t, w in zip(("x", "router", "w_up", "w_down"), ts, want):
        w = np.asarray(w, np.float32)
        err = np.abs(t.grad.numpy() - w).max()
        if dtype == torch.float32:
            assert err < F32_ATOL, (name, err)
        else:
            assert err / np.abs(w).max() < BF16_ATOL, (name, err)


def test_moe_ffn_keeps_a_nonfinite_row_local():
    """A NaN row (an inactive slot's attention row, say) takes capacity
    but poisons no other token, where the dense form's ``0 * NaN`` would
    reach them all: with room for every pair, the other rows equal a run
    in which that row is finite."""
    x, r, wu, wd = _inputs(13)
    kw = dict(top_k=2, capacity_factor=2.0, dtype=torch.float32)
    args = [torch.from_numpy(a) for a in (r, wu, wd)]
    bad = x.copy()
    bad[0, 3] = np.nan
    y_bad, _ = tmoe.moe_ffn(torch.from_numpy(bad), *args, **kw)
    y_ok, _ = tmoe.moe_ffn(torch.from_numpy(x), *args, **kw)
    rest = np.ones(x.shape[:2], bool)
    rest[0, 3] = False
    assert np.isfinite(y_bad.numpy()[rest]).all()
    np.testing.assert_array_equal(y_bad.numpy()[rest], y_ok.numpy()[rest])
    yj, _ = jmoe.moe_ffn(jnp.asarray(bad), *map(jnp.asarray, (r, wu, wd)),
                         top_k=2, capacity_factor=2.0, dtype=jnp.float32)
    assert not np.isfinite(np.asarray(yj)[rest]).all()    # the dense form


def test_moe_ffn_aux_false():
    x, r, wu, wd = _inputs(14)
    args = [torch.from_numpy(a) for a in (x, r, wu, wd)]
    kw = dict(top_k=2, capacity_factor=1.25, dtype=torch.float32)
    y0, a0 = tmoe.moe_ffn(*args, **kw)
    y1, a1 = tmoe.moe_ffn(*args, aux=False, **kw)
    assert a1 is None and torch.equal(y0, y1) and a0.dtype == torch.float32


# ------------------------------------------------------------ the model
def _cfgs(**kw):
    kw = {**NANO_MOE, **kw}
    return (dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                                **kw))


@pytest.fixture(scope="module")
def moe_tree():
    jcfg, _ = _cfgs()
    return jax.tree_util.tree_map(
        np.array, jgpt.init_params(jax.random.PRNGKey(0), jcfg))


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


def _flat(tree):
    blk = tree["block"]
    out = {"embed": tree["embed"]["kernel"], "pos_embed": tree["pos_embed"],
           "ln_f_scale": tree["ln_f_scale"]}
    for name in tgpt.MOE_BLOCK_PARAMS:
        leaf = blk[name]
        out[name] = leaf["kernel"] if isinstance(leaf, dict) else leaf
    return {k: np.asarray(v) for k, v in out.items()}


def test_params_from_numpy_moe_tree(moe_tree):
    p = tgpt.params_from_numpy(moe_tree, "cpu")
    assert set(p) == set(tgpt.MOE_BLOCK_PARAMS) | {"embed", "pos_embed",
                                                   "ln_f_scale"}
    for name, want in _flat(moe_tree).items():
        np.testing.assert_array_equal(p[name].numpy(), want)
    L, d, f = 2, 64, 256
    assert p["router"].shape == (L, d, 4)
    assert p["w_up"].shape == (L, 4, d, f)
    assert p["w_down"].shape == (L, 4, f, d)
    assert set(tgpt.layer_params(p, 1)) == set(tgpt.MOE_BLOCK_PARAMS)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_forward_and_loss_match_jax(moe_tree, cf):
    """Logits, loss, perplexity, ``moe_aux`` and the gradients, with
    every pair kept (cf 1.25) and with drops (cf 0.25)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    toks = _tokens(2, 24, seed=21)
    jp = jax.tree_util.tree_map(jnp.asarray, moe_tree)
    jlog, jaux = jgpt.forward(jp, jnp.asarray(toks[:, :-1]), jcfg,
                              return_aux=True)
    params = {k: v.requires_grad_(True)
              for k, v in tgpt.params_from_numpy(moe_tree, "cpu").items()}
    tlog, taux = tgpt.forward(params, toks[:, :-1], tcfg, return_aux=True)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=0, atol=F32_ATOL)
    assert abs(taux["moe_aux"].item() - float(jaux["moe_aux"])) < LOSS_TOL
    (jl, jm), jg = jax.value_and_grad(jgpt.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    loss, m = tgpt.loss_fn(params, {"tokens": torch.from_numpy(toks)}, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jl)) < LOSS_TOL
    for key in ("loss", "perplexity", "moe_aux"):
        scale = float(jm[key]) if key == "perplexity" else 1.0
        assert abs(m[key].item() - float(jm[key])) < LOSS_TOL * scale, key
    assert m["moe_aux"].item() > 0
    ref = _flat(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in params.items():
        err = np.abs(p.grad.numpy() - ref[name]).max() / \
            np.abs(ref[name]).max()
        assert err < GRAD_RTOL, (name, err)


def test_dense_forward_aux_is_zero():
    _, tcfg = _cfgs(n_experts=0)
    p = tgpt.init_params(tcfg, 0, device="cpu")
    logits, aux = tgpt.forward(p, _tokens(1, 8, 0)[:, :-1], tcfg,
                               return_aux=True)
    assert aux["moe_aux"].item() == 0.0 and logits.shape == (1, 8, 512)
    _, m = tgpt.loss_fn(p, {"tokens": _tokens(1, 8, 0)}, tcfg)
    assert "moe_aux" not in m


@pytest.mark.parametrize("remat,attn_backend", [("none", "xla"),
                                                ("dots", "flash")])
def test_train_steps_match_jax(remat, attn_backend):
    """Three ``make_train_step`` steps from the same weights on the same
    batch: losses and ``moe_aux`` within 1e-5, the loss falling, and each
    parameter within lr of the reference's (the dense test's bound,
    ``tests/test_torch_train.py``)."""
    from ray_tpu.parallel import create_mesh

    jcfg, tcfg = _cfgs(remat=remat, attn_backend=attn_backend)
    mesh = create_mesh({"dp": 1}, devices=[jax.devices()[0]])
    jinit, jstep, _, _ = jgpt.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    init, step, _, _ = tgpt.make_train_step(tcfg, device="cpu")
    state = init(params=tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.array, jstate["params"]), "cpu"))
    toks = _tokens(4, 32, seed=31)
    got, want = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        want.append((float(jm["loss"]), float(jm["moe_aux"])))
        got.append((m["loss"].item(), m["moe_aux"].item()))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert got[2][0] < got[0][0] and all(a > 0 for _, a in got)
    lr = tgpt.ADAMW_DEFAULTS["lr"]
    ref = _flat(jax.tree_util.tree_map(np.array, jstate["params"]))
    for name, p in state["params"].items():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= lr, (name, diff.max())


def test_remat_policies_equal_under_moe(moe_tree):
    """Routing recomputed in backward routes the same: every remat
    policy's gradients equal ``remat="none"``'s bit for bit."""
    toks = {"tokens": torch.from_numpy(_tokens(2, 32, seed=5))}
    grads = {}
    for remat in ("none", "dots", "full"):
        _, cfg = _cfgs(remat=remat, capacity_factor=0.5)
        params = {k: v.requires_grad_(True) for k, v in
                  tgpt.params_from_numpy(moe_tree, "cpu").items()}
        loss, _ = tgpt.loss_fn(params, toks, cfg)
        loss.backward()
        grads[remat] = {k: v.grad for k, v in params.items()}
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


def test_config_guards():
    base = tgpt.CONFIGS["nano"]
    for kw in (dict(n_experts=4, expert_top_k=5),
               dict(n_experts=4, expert_top_k=0), dict(n_experts=-1)):
        with pytest.raises(ValueError, match="top_k"):
            dataclasses.replace(base, **kw)
    cfg = dataclasses.replace(base, **NANO_MOE)
    assert (cfg.capacity_factor, cfg.moe_aux_coef) == (1.25, 0.01)
    j = jgpt.CONFIGS["nano"]
    assert (j.expert_top_k, j.capacity_factor, j.moe_aux_coef) == \
        (base.expert_top_k, base.capacity_factor, base.moe_aux_coef)
