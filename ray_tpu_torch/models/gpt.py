"""GPT-style decoder LM in PyTorch: the port of ``ray_tpu/models/gpt.py``.

Same model, same arithmetic, same parameter layout as the JAX reference,
so the two can be held against each other on the same weights:

- parameters are a flat dict of tensors with per-layer weights STACKED
  along a leading layer axis (the reference's ``params["block"]``
  pytree, flattened); kernels keep JAX's ``[in, out]`` layout, so
  ``x @ W`` needs no transpose. :class:`GPT` wraps the dict in an
  ``nn.Module``;
- the reference's ``lax.scan`` over layers is a Python loop over the
  layer index;
- every matmul runs in the compute dtype with f32 accumulation and one
  cast (:func:`_mm`), and every product that feeds a softmax or the
  logits is formed in f32 (bf16 operands upcast exactly), as the
  reference's ``preferred_element_type=jnp.float32`` does;
- GELU is the tanh approximation, which is ``jax.nn.gelu``'s default.

Dense FFN only: MoE (``n_experts > 0``) belongs to a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._private.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]

#: Per-layer weights, stacked along a leading ``[n_layer]`` axis.
BLOCK_PARAMS = ("ln1_scale", "ln2_scale", "wq", "wk", "wv", "wo", "w1",
                "w2")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16      # activation/matmul dtype
    param_dtype: torch.dtype = torch.float32  # master params
    n_experts: int = 0               # >0 → MoE FFN (not in this port yet)

    def __post_init__(self):
        if self.n_experts > 0:
            raise NotImplementedError(
                "MoE configs (n_experts > 0) are not ported yet; the "
                "torch port serves dense-FFN GPTs only")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


# sizes used by benchmarks / examples (ray_tpu/models/gpt.py:79)
CONFIGS = {
    "nano": GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=64,
                      d_ff=256, max_seq=128),
    "small": GPTConfig(),                                   # GPT-2 124M
    "medium": GPTConfig(n_layer=24, n_head=16, d_model=1024, d_ff=4096),
    "1b": GPTConfig(n_layer=24, n_head=16, d_model=2048, d_ff=8192,
                    max_seq=2048),
}


def init_params(cfg: GPTConfig, seed: int = 0, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights with the reference's shapes and scales
    (``gpt.py:95-137``), drawn from a seeded CPU ``torch.Generator`` so a
    seed gives the same weights on any device. Not bit-identical to
    ``jax.random``; tests that compare the two packages load the JAX
    weights through :func:`params_from_numpy` instead. ``dtype`` is the
    storage dtype (default ``cfg.param_dtype``); storing in the compute
    dtype changes no result, since every use casts to it first."""
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    gen = torch.Generator().manual_seed(int(seed))
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer

    def normal(shape, scale):
        return torch.randn(shape, generator=gen) * scale

    resid = 1.0 / math.sqrt(2 * L * d)
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "pos_embed": normal((cfg.max_seq, d), 0.01),
        "ln1_scale": torch.ones(L, d),
        "ln2_scale": torch.ones(L, d),
        "wq": normal((L, d, d), 1.0 / math.sqrt(d)),
        "wk": normal((L, d, d), 1.0 / math.sqrt(d)),
        "wv": normal((L, d, d), 1.0 / math.sqrt(d)),
        "wo": normal((L, d, d), resid),
        "w1": normal((L, d, f), 1.0 / math.sqrt(d)),
        "w2": normal((L, f, d), resid),
        "ln_f_scale": torch.ones(d),
    }
    return {k: v.to(device=dev, dtype=dtype) for k, v in params.items()}


def params_from_numpy(tree: Mapping, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> Params:
    """The reference's params pytree (``ray_tpu.models.gpt.init_params``,
    leaves already converted to numpy by the caller) → the port's flat
    dict of stacked tensors, ``[in, out]`` kernel layout kept."""
    dev = resolve_device(device)
    blk = tree["block"]
    if "w1" not in blk:
        raise NotImplementedError("MoE params are not ported yet")

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=dtype)

    out = {"embed": t(tree["embed"]["kernel"]),
           "pos_embed": t(tree["pos_embed"]),
           "ln_f_scale": t(tree["ln_f_scale"])}
    for name in BLOCK_PARAMS:
        leaf = blk[name]
        out[name] = t(leaf["kernel"] if isinstance(leaf, Mapping) else leaf)
    return out


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights (views into the stacked tensors)."""
    return {name: params[name][i] for name in BLOCK_PARAMS}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # x (compute dtype) * f32 rsqrt promotes to f32, is cast back to the
    # compute dtype, then scaled in it — the reference's promotion order.
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
        ) -> torch.Tensor:
    """Compute-dtype GEMM with f32 accumulation and one cast (the CUDA
    reduction precision is pinned by
    :func:`~ray_tpu_torch._private.device.set_matmul_precision`)."""
    return torch.matmul(x.to(dtype), w.to(dtype)).to(dtype)


def _project_vocab(x: torch.Tensor, embed: torch.Tensor, cfg: GPTConfig
                   ) -> torch.Tensor:
    """Tied-embedding vocab projection, **f32 logits** out. The operands
    are rounded to the compute dtype and then upcast (exact), so the f32
    product is the reference's bf16-in/f32-out ``dot_general``; a bf16
    ``matmul`` would round the logits and flip greedy ties."""
    return torch.matmul(x.to(cfg.dtype).float(),
                        embed.to(cfg.dtype).float().t())


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True (tanh form).
    return F.gelu(x, approximate="tanh")


def _attention_xla(q, k, v, cfg: GPTConfig) -> torch.Tensor:
    """[B, S, H, hd] causal attention: f32 logits, masked softmax, probs
    cast to the compute dtype, f32-accumulated p·v (``gpt.py:151``)."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def _block(x: torch.Tensor, p: Params, cfg: GPTConfig) -> torch.Tensor:
    """One dense transformer block (``gpt.py:234``)."""
    B, S, d = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    h = _rmsnorm(x, p["ln1_scale"])
    q = _mm(h, p["wq"], cfg.dtype).reshape(B, S, H, hd)
    k = _mm(h, p["wk"], cfg.dtype).reshape(B, S, H, hd)
    v = _mm(h, p["wv"], cfg.dtype).reshape(B, S, H, hd)
    att = _attention_xla(q, k, v, cfg).reshape(B, S, d)
    x = x + _mm(att, p["wo"], cfg.dtype)
    h = _rmsnorm(x, p["ln2_scale"])
    h = _gelu(_mm(h, p["w1"], cfg.dtype))
    return x + _mm(h, p["w2"], cfg.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig
            ) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, vocab] float32."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    S = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
    for i in range(cfg.n_layer):
        x = _block(x, layer_params(params, i), cfg)
    x = _rmsnorm(x, params["ln_f_scale"])
    return _project_vocab(x, params["embed"], cfg)


class GPT(nn.Module):
    """``nn.Module`` holding the stacked parameters; ``forward(tokens)``
    is :func:`forward`. Inference-only: the weights do not require
    grad."""

    def __init__(self, cfg: GPTConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict({
            name: nn.Parameter(t, requires_grad=False)
            for name, t in params.items()})

    def params(self) -> Params:
        return dict(self.weights.items())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)
