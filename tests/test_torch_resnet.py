"""The port's ResNet (``ray_tpu_torch.models.resnet``) against the JAX
reference (``ray_tpu.models.resnet``) on the CPU, with inputs made from
numpy seeds.

``init_params`` draws the reference's weights bit for bit (ResNet-18 at
width 16, ResNet-50 at width 4; the reference's eager draw compiles
every op, ~10 s a tree here); ``num_params`` is the reference's. The
convolutions pad SAME as XLA does (asymmetric where the total is odd,
which a symmetric ``padding=`` gets wrong), and the max-pool pads with
``-inf``. At f32, on ResNet-18 width 16 and 64x64 images (whose stem
and stride-2 convs all pad asymmetrically): the inference logits, the
``train=True`` logits and every updated batch-norm statistic, the
predictor's ``uint8_input`` path, and the gradients of a loss on the
``train=True`` logits against ``jax.grad``, each within the bound its
test states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import resnet as jres
from ray_tpu_torch.models import resnet as tres
from torch_threads import one_torch_thread  # noqa: F401

# f32 logits: the convolutions sum in another order in each framework;
# |logits| < 3 here, and the largest difference measured was 1.9e-6.
LOGIT_ATOL = 2e-5
# Batch-norm means/variances (|value| < 10): f32 reductions of up to
# 2048 terms per channel, summed in another order.
STAT_ATOL = 1e-5
STAT_RTOL = 1e-5
# Gradients: relative to the leaf's largest gradient.
GRAD_RTOL = 1e-4


def _cfgs(depth=18, width=16, num_classes=10, dtype="float32"):
    return (jres.ResNetConfig(depth=depth, num_classes=num_classes,
                              width=width, dtype=getattr(jnp, dtype)),
            tres.ResNetConfig(depth=depth, num_classes=num_classes,
                              width=width, dtype=getattr(torch, dtype)))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_numpy(tree):
    return tres._map(lambda t: t.detach().numpy(), tree)


def _images(seed=0, b=2, hw=64):
    return (np.random.default_rng(seed).standard_normal((b, hw, hw, 3))
            * 2 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jp = jres.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, tres.params_from_numpy(_numpy(jp), "cpu")


@pytest.mark.parametrize("depth,width", [(18, 16), (50, 4)])
def test_init_params_bit_equal(tiny, depth, width):
    """ResNet-18 against the ``tiny`` fixture's draw (seed 0),
    ResNet-50 against a draw for seed 3."""
    jcfg, tcfg = _cfgs(depth, width)
    seed = 0 if depth == 18 else 3
    want = _numpy(tiny[2] if depth == 18 else jres.init_params(
        jax.random.PRNGKey(seed), jcfg))
    got = _port_numpy(tres.init_params(tcfg, seed, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if depth == 18:      # a key array draws what its int seed draws
        again = tres.init_params(tcfg, np.asarray(jax.random.PRNGKey(0)),
                                 device="cpu")
        np.testing.assert_array_equal(again["head"]["kernel"].numpy(),
                                      want["head"]["kernel"])


@pytest.mark.parametrize("depth", [18, 50, 101])
def test_num_params(depth):
    full = tres.ResNetConfig(depth=depth)
    assert full.num_params() == jres.ResNetConfig(depth=depth).num_params()
    if depth == 50:      # ~25.6M, as tests/test_models_resnet.py holds it
        assert 24e6 < full.num_params() < 27e6


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (7, 3, 2, (1, 1)),
    (1, 7, 2, (3, 3))])
def test_same_padding_is_xla(size, k, stride, want):
    assert tres._same(size, k, stride) == want


@pytest.mark.parametrize("hw,k,stride", [(9, 3, 2), (8, 3, 2), (8, 7, 2),
                                         (7, 1, 2), (8, 3, 1)])
def test_conv_and_pool_match_lax(hw, k, stride):
    """``_conv`` and the max-pool on NHWC inputs equal the reference's
    ``lax`` calls; a symmetric ``padding=k//2`` does not where SAME is
    asymmetric."""
    from jax import lax

    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(hw * 10 + k)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride,
                                 jcfg))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tres._conv(xt, torch.from_numpy(w), stride, tcfg)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pads = tres._same(hw, k, stride)
    if pads[0] != pads[1]:
        naive = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1),
                         stride=stride, padding=k // 2)
        assert naive.permute(0, 2, 3, 1).shape != want.shape or \
            not np.allclose(naive.permute(0, 2, 3, 1).numpy(), want,
                            atol=1e-3)
    pool = np.asarray(lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max,
                                        (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    np.testing.assert_array_equal(
        tres._max_pool(xt).permute(0, 2, 3, 1).numpy(), pool)


def test_inference_logits(tiny):
    jcfg, tcfg, jp, tp = tiny
    x = _images(0)
    want = np.asarray(jres.forward(jp, x, jcfg))
    got = tres.forward(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_train_logits_and_bn_statistics(tiny):
    """``train=True``: logits, and every batch norm's updated running
    mean/var (scale and bias unchanged); ``params`` itself untouched."""
    jcfg, tcfg, jp, tp = tiny
    x = _images(1, b=4)
    jl, jnew = jres.forward(jp, x, jcfg, train=True)
    before = _port_numpy(tp)
    tl, tnew = tres.forward(tp, torch.from_numpy(x), tcfg, train=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    want, got = _numpy(jnew), _port_numpy(tnew)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, a), b in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=STAT_RTOL, atol=STAT_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(
            _port_numpy(tp))):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(got["stem"]["bn"]["mean"],
                           before["stem"]["bn"]["mean"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_uint8_input(tiny, dtype):
    """``uint8_input``: cast to ``cfg.dtype`` and multiplied by ``1/255``
    rounded to it, bit for bit the reference's normalised input; at f32
    the logits are the reference predictor's within ``LOGIT_ATOL``."""
    jcfg, tcfg, jp, tp = tiny
    jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    u8 = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
    got = tres.make_predictor(tcfg, tp, uint8_input=True)(u8)
    norm = np.array((jnp.asarray(u8).astype(jcfg.dtype) * jnp.asarray(
        1.0 / 255.0, jcfg.dtype)).astype(jnp.float32))
    direct = tres.forward(tp, torch.from_numpy(norm).to(tcfg.dtype), tcfg)
    torch.testing.assert_close(got, direct, rtol=0, atol=0)
    if dtype == "float32":
        want = np.asarray(jres.make_predictor(jcfg, jp, uint8_input=True)(
            jnp.asarray(u8)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGIT_ATOL)


def test_gradients_match_jax(tiny):
    """``mean((logits - 1)^2)`` on the ``train=True`` logits: every
    leaf's gradient against ``jax.grad`` within ``GRAD_RTOL`` of that
    leaf's largest gradient (the running statistics get none)."""
    jcfg, tcfg, jp, _ = tiny
    x = _images(2)

    def jloss(p):
        logits, _ = jres.forward(p, x, jcfg, train=True)
        return jnp.mean((logits - 1.0) ** 2)

    want = _numpy(jax.grad(jloss)(jp))
    tp = tres.params_from_numpy(_numpy(jp), "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    logits, _ = tres.forward(tp, torch.from_numpy(x), tcfg, train=True)
    ((logits - 1.0) ** 2).mean().backward()
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, g), t in zip(flat, jax.tree.leaves(tp)):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name or "'var'" in name:
            assert t.grad is None or not t.grad.any(), name
            continue
        scale = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)
