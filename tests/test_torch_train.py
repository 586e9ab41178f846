"""The port's training step (``ray_tpu_torch.models.gpt``: ``loss_fn``,
``_chunked_ce``, the remat policies, ``make_train_step``) against the JAX
reference (``ray_tpu.models.gpt``) on the same nano weights at f32.

The JAX weights come from ``ray_tpu.models.gpt.init_params`` /
``make_train_step``'s ``init`` and reach torch through numpy
(``params_from_numpy``); tokens come from a numpy seed. Everything runs on
the CPU: the port's ``flash`` backend takes its plain versions there, the
reference's runs its Pallas kernels in the interpreter.
"""
import dataclasses
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from torch_threads import one_torch_thread  # noqa: F401

# f32: the packages differ in f32 summation order only; losses of ~6.3
# agree to ~1e-6, gradients to ~1e-6 of their largest entry.
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), jgpt.CONFIGS["nano"])


@pytest.fixture(scope="module")
def np_tree(jax_params):
    return jax.tree_util.tree_map(np.array, jax_params)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


def _cfgs(**kw):
    """The nano preset (bf16 compute) at f32 compute, for both packages."""
    return (dataclasses.replace(jgpt.CONFIGS["nano"], dtype=jnp.float32,
                                **kw),
            dataclasses.replace(tgpt.CONFIGS["nano"], dtype=torch.float32,
                                **kw))


def _flat_jax_grads(tree):
    """The reference's grads pytree in the port's flat key layout."""
    blk = tree["block"]
    out = {"embed": tree["embed"]["kernel"], "pos_embed": tree["pos_embed"],
           "ln_f_scale": tree["ln_f_scale"]}
    for name in tgpt.BLOCK_PARAMS:
        leaf = blk[name]
        out[name] = leaf["kernel"] if isinstance(leaf, dict) else leaf
    return {k: np.asarray(v) for k, v in out.items()}


def _port_loss_and_grads(np_tree, batch, cfg):
    params = {k: v.requires_grad_(True)
              for k, v in tgpt.params_from_numpy(np_tree, "cpu").items()}
    loss, metrics = tgpt.loss_fn(params, batch, cfg)
    loss.backward()
    return loss.item(), metrics, {k: v.grad.numpy()
                                  for k, v in params.items()}


@pytest.mark.parametrize("loss_chunk", [0, 8, 10, 64])
def test_loss_fn_and_grads_match_jax(jax_params, np_tree, loss_chunk):
    """Unchunked, chunks dividing S=24, chunks of 10 with a ragged tail of
    4, and a chunk longer than S (one chunk)."""
    jcfg, tcfg = _cfgs(loss_chunk=loss_chunk)
    toks = _tokens(2, 24, seed=loss_chunk)
    (jl, jm), jg = jax.value_and_grad(jgpt.loss_fn, has_aux=True)(
        jax_params, {"tokens": jnp.asarray(toks)}, jcfg)
    loss, metrics, grads = _port_loss_and_grads(
        np_tree, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert abs(loss - float(jl)) < LOSS_TOL
    assert abs(metrics["perplexity"].item() - float(jm["perplexity"])) \
        < LOSS_TOL * float(jm["perplexity"])
    ref = _flat_jax_grads(jg)
    for name, g in grads.items():
        err = np.abs(g - ref[name]).max() / np.abs(ref[name]).max()
        assert err < GRAD_RTOL, (name, err)


@pytest.mark.parametrize("chunk,S", [(8, 24), (10, 24), (7, 7), (5, 3)])
def test_chunked_ce_matches_jax(chunk, S):
    rng = np.random.default_rng(chunk + S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    embed = (rng.standard_normal((512, 64)) * 0.02).astype(np.float32)
    targets = rng.integers(0, 512, (2, S)).astype(np.int32)
    jcfg, tcfg = _cfgs(loss_chunk=chunk)
    jl, (jgx, jge) = jax.value_and_grad(jgpt._chunked_ce, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(targets), jcfg)
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(embed, requires_grad=True)
    loss = tgpt._chunked_ce(tx, te, torch.from_numpy(targets), tcfg)
    loss.backward()
    assert abs(loss.item() - float(jl)) < LOSS_TOL
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("attn_backend", ["xla", "flash"])
def test_train_steps_match_jax(attn_backend):
    """Three steps of ``make_train_step`` from the same weights on the
    same batch: the loss trajectory agrees within 1e-5 (measured 9.5e-7),
    and every parameter within lr (measured 0.05 lr). Adam divides each
    update by the root of its second moment, so a weight whose gradient
    is ~1e-8 can move by up to lr per step on one side and not the other
    when f32 summation order flips its gradient's sign; the bulk agrees
    far closer (median checked at 1e-3 lr, measured 2e-4 lr)."""
    from ray_tpu.parallel import create_mesh

    jcfg, tcfg = _cfgs(attn_backend=attn_backend)
    mesh = create_mesh({"dp": 1}, devices=[jax.devices()[0]])
    jinit, jstep, _, _ = jgpt.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.array, jstate["params"])
    init, step, _, _ = tgpt.make_train_step(tcfg, device="cpu")
    state = init(params=tgpt.params_from_numpy(np_tree, "cpu"))
    toks = _tokens(4, 64, seed=11)
    jlosses, losses = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    assert state["step"] == 3
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
    assert losses[2] < losses[0]
    lr = tgpt.ADAMW_DEFAULTS["lr"]
    ref = _flat_jax_grads(jax.tree_util.tree_map(np.array,
                                                 jstate["params"]))
    for name, p in state["params"].items():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= lr, (name, diff.max())
        assert np.median(diff) <= 1e-3 * lr, (name, np.median(diff))


@pytest.mark.parametrize("attn_backend", ["xla", "flash"])
@pytest.mark.parametrize("remat", ["dots", "full", True])
def test_remat_policies_give_equal_gradients(np_tree, remat, attn_backend):
    """Recomputing in backward changes no number: every policy's
    gradients equal ``remat="none"``'s bit for bit on the CPU."""
    toks = {"tokens": torch.from_numpy(_tokens(2, 32, seed=5))}
    _, base = _cfgs(remat="none", attn_backend=attn_backend)
    _, cfg = _cfgs(remat=remat, attn_backend=attn_backend)
    l0, _, g0 = _port_loss_and_grads(np_tree, toks, base)
    l1, _, g1 = _port_loss_and_grads(np_tree, toks, cfg)
    assert l0 == l1
    for name in g0:
        np.testing.assert_array_equal(g1[name], g0[name], err_msg=name)


@pytest.mark.parametrize("name", ["nano", "small", "medium", "1b"])
def test_num_params_and_flops_match_jax(name):
    j, t = jgpt.CONFIGS[name], tgpt.CONFIGS[name]
    assert t.num_params() == j.num_params()
    assert t.flops_per_token() == j.flops_per_token()
    assert t.loss_chunk == j.loss_chunk
    assert (t.remat, t.attn_backend) == (j.remat, j.attn_backend)
    if name == "nano":       # counts what init_params makes
        p = tgpt.init_params(t, seed=0, device="cpu")
        assert sum(v.numel() for v in p.values()) == t.num_params()


def test_adamw_defaults_match_optax():
    """The default optimizer is ``optax.adamw(3e-4, weight_decay=0.01)``
    (``gpt.py:514``): same hyperparameters, and three updates of the same
    parameters from the same gradients agree to f32 rounding (1e-6 is ~4
    ulps at the largest |p|, 2.3; the two order their f32 ops
    differently)."""
    import optax

    sig = inspect.signature(optax.adamw).parameters
    d = tgpt.ADAMW_DEFAULTS
    assert d["betas"] == (sig["b1"].default, sig["b2"].default)
    assert d["eps"] == sig["eps"].default and sig["eps_root"].default == 0
    assert d["lr"] == 3e-4 and d["weight_decay"] == 0.01
    init, *_ = tgpt.make_train_step(tgpt.CONFIGS["nano"], device="cpu")
    opt = init()["opt"]
    assert opt.defaults["lr"] == d["lr"] and not opt.defaults["amsgrad"]
    assert opt.defaults["weight_decay"] == d["weight_decay"]

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64,)).astype(np.float32)
    grads = [rng.standard_normal((64,)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = optax.adamw(3e-4, weight_decay=0.01)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = tgpt._default_optimizer([tp])
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


def test_batch_forms_agree(np_tree):
    """``tokens [B, S+1]`` and ``tokens`` + ``targets`` give one loss."""
    toks = _tokens(2, 16, seed=9)
    params = tgpt.params_from_numpy(np_tree, "cpu")
    _, cfg = _cfgs()
    a, _ = tgpt.loss_fn(params, {"tokens": toks}, cfg)
    b, _ = tgpt.loss_fn(params, {"tokens": toks[:, :-1],
                                 "targets": toks[:, 1:]}, cfg)
    assert a.item() == b.item()


def test_attention_backends(np_tree):
    """``auto`` resolves to ``xla`` on CPU tensors (the reference resolves
    it to xla off the TPU); ``flash`` on CPU tensors runs the plain
    versions and gives the xla path's logits within f32 noise."""
    from ray_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 8, 2, 32)
    assert tgpt._resolve_attn_backend(tgpt.CONFIGS["nano"], q) == "xla"
    _, xla = _cfgs()
    _, flash = _cfgs(attn_backend="flash")
    assert tgpt._resolve_attn_backend(flash, q) == "flash"
    params = tgpt.params_from_numpy(np_tree, "cpu")
    toks = torch.from_numpy(_tokens(2, 40, seed=2)[:, :-1])
    before = dict(fa.launches)
    with torch.no_grad():
        a = tgpt.forward(params, toks, xla)
        b = tgpt.forward(params, toks, flash)
    assert fa.launches == before
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "flash"), (torch.float16, 64, "xla"),
    (torch.bfloat16, 80, "xla")])
def test_auto_backend_on_cuda_tensors(dtype, hd, want):
    """``auto`` on a CUDA tensor resolves to ``flash`` where the kernels
    take its dtype and head_dim, else to ``xla`` with a warning. A
    stand-in carries the device, dtype and shape: no card here."""
    class CudaLike:
        device = torch.device("cuda")
        shape = (1, 8, 2, hd)

        def __init__(self):
            self.dtype = dtype

        def dim(self):
            return 4

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tgpt._resolve_attn_backend(tgpt.CONFIGS["nano"], CudaLike())
    assert got == want
    assert bool(caught) == (want == "xla")


def test_config_guards():
    nano = tgpt.CONFIGS["nano"]
    toks = torch.zeros(1, 8, dtype=torch.long)
    params = tgpt.init_params(nano, device="cpu")
    for backend in ("ring", "ulysses"):   # sequence parallel: needs a mesh
        cfg = dataclasses.replace(nano, attn_backend=backend, sp_axis="sp")
        with pytest.raises(ValueError, match="needs a mesh with the sp"):
            tgpt.forward(params, toks, cfg)
    with pytest.raises(ValueError):
        dataclasses.replace(nano, attn_backend="pallas")
    with pytest.raises(ValueError):
        dataclasses.replace(nano, remat="block")
    assert tgpt._remat_policy(True) == "full"
    assert tgpt._remat_policy(False) == "none"
    assert tgpt.CONFIGS["1b"].loss_chunk == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgpt.make_train_step(nano)
