"""Flash attention: the port's plain forward and backward against the JAX
``flash_attention`` (Pallas interpreter on the CPU, as
``tests/test_ops_flash.py`` runs it) and its VJP, against the reference's
``_attention_xla``, a float64 gradcheck of the autograd Function, the
kernel wrappers' input checks, and — on a machine with a card — the CUDA
kernels against the plain versions.

Inputs come from a numpy seed and reach both packages as numpy arrays.
JAX is imported inside the tests that compare with it, so that
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``
runs the card cases on a machine that has no JAX.
"""
import math
import shutil

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

# f32: both packages compute the same function in f32 and differ in
# summation order only (measured ~1e-6 here); 1e-4 is the tolerance of
# tests/test_ops_flash.py for the same comparison.
TOL = 1e-4


def _inputs(S, Sk, hd, seed, B=2, H=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, g


def _port(q, k, v, g, causal, dtype=torch.float32):
    """Output and (dq, dk, dv) for cotangent g, as float32 numpy."""
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    o = fa.flash_attention(*ts, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    o.backward(torch.tensor(g, dtype=dtype))
    return (o.detach().float().numpy(),
            [t.grad.float().numpy() for t in ts])


def _jax(fn, q, k, v, g, dtype="float32"):
    import jax
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    args = [jnp.asarray(x, jd) for x in (q, k, v)]
    o, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g, jd))
    return (np.asarray(o, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("S,Sk,hd,causal", [
    (64, 64, 32, True),
    (128, 128, 64, True),
    (100, 100, 32, True),          # S not a power of two: one block of 100
    (256, 256, 64, False),
    (64, 128, 32, False),          # non-causal, Sk != S
])
def test_plain_matches_jax_flash_and_its_vjp(S, Sk, hd, causal):
    from ray_tpu.ops.flash_attention import flash_attention as jfa

    q, k, v, g = _inputs(S, Sk, hd, seed=S + Sk + hd)
    out, grads = _port(q, k, v, g, causal)
    ref, rgrads = _jax(lambda a, b, c: jfa(a, b, c, causal=causal),
                       q, k, v, g)
    assert np.abs(out - ref).max() < TOL
    for name, a, b in zip("qkv", grads, rgrads):
        assert _rel(a, b) < TOL, name


def _jax_reference_attention(causal, hd):
    """The reference's ``_attention_xla`` (causal), or the unmasked
    einsum softmax ``tests/test_ops_flash.py`` compares non-causal flash
    with."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt import GPTConfig, _attention_xla

    if causal:
        cfg = GPTConfig(n_head=2, d_model=2 * hd)
        return lambda q, k, v: _attention_xla(q, k, v, cfg)

    def full(q, k, v):
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                            preferred_element_type=jnp.float32)
        p = jax.nn.softmax(logits / math.sqrt(hd), axis=-1).astype(q.dtype)
        return jnp.einsum("bhqk,bkhd->bqhd", p, v,
                          preferred_element_type=jnp.float32)
    return full


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [64, 100, 256])
def test_matches_attention_xla(S, hd, causal):
    q, k, v, g = _inputs(S, S, hd, seed=7 * S + hd)
    out, grads = _port(q, k, v, g, causal)
    ref, rgrads = _jax(_jax_reference_attention(causal, hd), q, k, v, g)
    assert np.abs(out - ref).max() < TOL
    for name, a, b in zip("qkv", grads, rgrads):
        assert _rel(a, b) < TOL, name


@pytest.mark.parametrize("hd", [64, 128])
def test_bf16_rounding_points_match_jax_flash(hd):
    """In bf16 the port rounds where the reference rounds: q scaled in
    bf16 (at hd=128, 1/sqrt(128) is not exact in bf16), p cast before
    p.v, dS cast before its products. The reference is blockwise and the
    plain version one block, so p may round one ulp apart; 2e-2 is ~2
    bf16 ulps at the outputs' magnitude (|o| < 2)."""
    import jax.numpy as jnp

    from ray_tpu.ops.flash_attention import flash_attention as jfa

    q, k, v, g = _inputs(128, 128, hd, seed=hd)
    out, grads = _port(q, k, v, g, True, torch.bfloat16)
    ref, rgrads = _jax(lambda a, b, c: jfa(a, b, c, causal=True),
                       q, k, v, g, "bfloat16")
    assert np.abs(out - ref).max() < 2e-2
    for name, a, b in zip("qkv", grads, rgrads):
        assert _rel(a, b) < 2e-2, name
    # The pre-scale itself is bit-equal to the reference's.
    scale = 1.0 / math.sqrt(hd)
    tq = torch.tensor(q, dtype=torch.bfloat16)
    jq = jnp.asarray(q, jnp.bfloat16) * jnp.asarray(scale, jnp.bfloat16)
    np.testing.assert_array_equal(fa.scale_q(tq, scale).float().numpy(),
                                  np.asarray(jq, np.float32))


@pytest.mark.parametrize("S,Sk,causal", [(6, 6, True), (4, 7, False)])
def test_gradcheck_float64(S, Sk, causal):
    """The Function's backward (the plain backward's written-out formulas)
    is the derivative of its forward."""
    rng = np.random.default_rng(S * Sk)
    args = [torch.tensor(rng.standard_normal((1, n, 2, 4)),
                         dtype=torch.float64, requires_grad=True)
            for n in (S, Sk, Sk)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal), args)


def test_wrappers_on_cpu_run_the_plain_versions():
    q, k, v, g = _inputs(40, 40, 32, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(*t[:3], True)
    ro, rlse = fa.flash_fwd_plain(*t[:3], True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert lse.shape == (2, 2, 40, 1) and lse.dtype == torch.float32
    got = fa.flash_bwd(*t[:3], o, lse, t[3], 0.5, True)
    ref = fa.flash_bwd_plain(*t[:3], o, lse, t[3], 0.5, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fa.launches == before       # no kernel ran
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_fwd(*[x.to("meta") for x in t[:3]], True)


def test_kernel_wrapper_rejects_what_the_kernels_cannot_take():
    """Checked on CPU tensors, which the validation does not care about."""
    q, k, v, _ = _inputs(32, 32, 64, seed=4)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    lse = torch.zeros(2, 2, 32, 1)
    fa._check(tq, tk, tv, tq, lse, tq)            # accepted
    assert fa.supported(tq) and not fa.supported(tq.half())
    bad = [
        ((tq.half(), tk.half(), tv.half()), ValueError),     # dtype
        ((tq[..., :48].contiguous(), tk[..., :48].contiguous(),
          tv[..., :48].contiguous()), ValueError),           # head_dim 48
        ((tq, tk.float(), tv), TypeError),                   # mixed dtypes
        ((tq, tk[:, :, :1].contiguous(), tv), ValueError),   # heads differ
        ((tq, tk, tv[:, :16].contiguous()), ValueError),     # k/v lengths
        ((tq, tk.transpose(1, 2).contiguous().transpose(1, 2), tv),
         ValueError),                                        # layout
        ((tq, tk, tv, tq[:, :16], lse, tq), ValueError),     # o shape
        ((tq, tk, tv, tq, lse.double(), tq), ValueError),    # lse dtype
        ((tq, tk, tv, tq, lse[:, :1], tq), ValueError),      # lse shape
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            fa._check(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,S,Sk,causal,B,H", [
    ("bfloat16", 64, 256, 256, True, 2, 2),
    ("bfloat16", 64, 200, 200, True, 2, 2),      # ragged tail
    ("bfloat16", 32, 96, 160, False, 2, 2),      # non-causal, Sk != S
    ("bfloat16", 128, 130, 130, True, 2, 2),
    ("float32", 32, 100, 100, True, 2, 2),
    ("float32", 128, 64, 96, False, 2, 2),
    # The bf16 kernels' tile edges: q and key tiles of 128 (dQ's key
    # tiles 64 at hd 128), q tiles of 64 (32 at hd 128) in dK/dV.
    ("bfloat16", 64, 1, 1, True, 2, 2),          # one position
    ("bfloat16", 64, 127, 127, True, 2, 2),
    ("bfloat16", 64, 129, 129, True, 2, 2),
    ("bfloat16", 64, 7, 1, False, 2, 2),         # one key
    ("bfloat16", 128, 1000, 1000, True, 2, 2),
    ("bfloat16", 64, 512, 512, True, 8, 12),     # several waves of blocks
])
def test_cuda_kernels_match_plain(dtype, hd, S, Sk, causal, B, H):
    """K2, K3a and K3b against the plain versions on the card, same
    inputs. f32: summation order only (1e-4 relative). bf16: p and dS
    round to bf16 at other points of a blockwise sweep than of the plain
    single block, so outputs can sit ~2 ulps apart (3e-2 relative).
    With one visible key per row (Sk = 1, or S = 1 under the causal
    mask) p is exactly 1 and dS = dP - delta is 0 up to rounding, so the
    exact dq and dk are 0: both versions return rounding noise (~1e-7)
    there, held to 1e-5 absolute instead of a relative bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    td = getattr(torch, dtype)
    q, k, v, g = _inputs(S, Sk, hd, seed=hd + S, B=B, H=H)
    qs, k, v, do = (torch.from_numpy(x).to("cuda", td) for x in (q, k, v, g))
    tol = 1e-4 if dtype == "float32" else 3e-2
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(qs, k, v, causal)
    grads = fa.flash_bwd(qs, k, v, o, lse, do, 0.125, causal)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == dict.fromkeys(
        before, 1)
    ro, rlse = fa.flash_fwd_plain(qs, k, v, causal)
    rgrads = fa.flash_bwd_plain(qs, k, v, o, lse, do, 0.125, causal)
    assert _rel(o.float().cpu().numpy(), ro.float().cpu().numpy()) < tol
    assert _rel(lse.cpu().numpy(), rlse.cpu().numpy()) < 1e-5
    one_key = Sk == 1 or (S == 1 and causal)
    for name, a, b in zip("qkv", grads, rgrads):
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if one_key and name in "qk":
            assert np.abs(a).max() < 1e-5 and np.abs(b).max() < 1e-5, name
        else:
            assert _rel(a, b) < tol, name


def test_kernel_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A changed ``csrc/`` header gives the flash library a new path, so
    a build never reuses a library compiled from the old header; a
    changed source moves only its own library."""
    from ray_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("flash_attention")] == [
        "flash_attention.cu", "hopper.cuh"]
    before = _build.library_path("flash_attention")
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    flash = _build.library_path("flash_attention")
    assert flash != before
    paged = csrc / "paged_attention.cu"
    paged.write_text(paged.read_text() + "\n// changed\n")
    assert _build.library_path("flash_attention") == flash
