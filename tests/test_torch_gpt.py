"""The port's GPT forward core (``ray_tpu_torch.models.gpt``) against the
JAX reference (``ray_tpu.models.gpt``) on the same nano weights.

The JAX weights come from ``ray_tpu.models.gpt.init_params`` and reach
torch through numpy (``params_from_numpy``); inputs come from a numpy
seed. Everything runs on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), jgpt.CONFIGS["nano"])


@pytest.fixture(scope="module")
def np_tree(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


# f32: the two packages differ only in f32 summation order (measured
# max |diff| ~5e-7 on logits of magnitude ~0.65), so 1e-5 leaves a wide
# margin yet would catch any change of arithmetic (a bf16 rounding, erf
# GELU, a missed promotion). bf16: activations round to bf16 at other
# places in the two frameworks' kernels; 2e-2 is ~5 bf16 ulps at the
# largest logit, and greedy choices must agree on >= 90% of positions
# (measured 98%).
@pytest.mark.parametrize("dtype,atol,min_argmax_agree", [
    ("float32", 1e-5, 1.0),
    ("bfloat16", 2e-2, 0.9),
])
def test_forward_parity(jax_params, np_tree, dtype, atol, min_argmax_agree):
    jcfg = dataclasses.replace(jgpt.CONFIGS["nano"],
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tgpt.CONFIGS["nano"],
                               dtype=getattr(torch, dtype))
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(jgpt.forward(jax_params, jnp.asarray(tokens), jcfg))
    model = tgpt.GPT(tcfg, tgpt.params_from_numpy(np_tree, "cpu"))
    out = model(torch.from_numpy(tokens))
    assert out.dtype == torch.float32          # f32 logits, as JAX
    out = out.numpy()
    assert out.shape == ref.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    agree = (out.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= min_argmax_agree, agree


def test_params_from_numpy_round_trip(np_tree):
    """Every JAX leaf lands unchanged, stacked, in [in, out] layout; and
    storing the weights in the compute dtype changes no result (every
    use casts to it first)."""
    cfg = tgpt.CONFIGS["nano"]
    p = tgpt.params_from_numpy(np_tree, "cpu")
    blk = np_tree["block"]
    np.testing.assert_array_equal(p["embed"].numpy(),
                                  np_tree["embed"]["kernel"])
    np.testing.assert_array_equal(p["pos_embed"].numpy(),
                                  np_tree["pos_embed"])
    np.testing.assert_array_equal(p["ln_f_scale"].numpy(),
                                  np_tree["ln_f_scale"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
        np.testing.assert_array_equal(p[name].numpy(), blk[name]["kernel"])
    for name in ("ln1_scale", "ln2_scale"):
        np.testing.assert_array_equal(p[name].numpy(), blk[name])
    L, d, f = cfg.n_layer, cfg.d_model, cfg.d_ff
    assert p["w1"].shape == (L, d, f) and p["w2"].shape == (L, f, d)
    assert all(t.dtype == torch.float32 for t in p.values())
    assert set(p) == set(tgpt.BLOCK_PARAMS) | {"embed", "pos_embed",
                                               "ln_f_scale"}
    # Port-initialized weights have the same tree shape as JAX's.
    q = tgpt.init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in q.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    tokens = torch.arange(10)[None] % cfg.vocab_size
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    a = tgpt.forward(p, tokens, bcfg)
    b = tgpt.forward(tgpt.params_from_numpy(np_tree, "cpu",
                                            dtype=torch.bfloat16),
                     tokens, bcfg)
    assert torch.equal(a, b)


def test_uses_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation; the port's block
    must use it (erf GELU differs by up to ~1e-3 here, far above f32
    noise)."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    out = tgpt._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - ref).max() > 1e-4


def test_device_and_config_guards():
    """No device means the card: without one the entry point raises
    rather than falling back to the CPU. MoE configs are accepted;
    sequence-parallel attention backends are accepted and refused
    without a mesh that has their sp axis."""
    moe = dataclasses.replace(tgpt.CONFIGS["nano"], n_experts=4)
    assert (moe.n_experts, moe.expert_top_k) == (4, 2)
    for backend in ("ring", "ulysses"):
        cfg = dataclasses.replace(tgpt.CONFIGS["nano"], attn_backend=backend)
        with pytest.raises(ValueError, match="needs a mesh with the sp"):
            tgpt._attention(*(torch.zeros(1, 4, 2, 32),) * 3, cfg)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the no-card error path cannot "
                    "be exercised")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_params(tgpt.CONFIGS["nano"])
