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

Training (``gpt.py:344-559``): :func:`forward` with the remat policies,
:func:`loss_fn` with the chunked cross-entropy, and
:func:`make_train_step` (single card, ``torch.optim.AdamW``). Attention
goes through :func:`_attention`: ``"flash"`` is the hand-written kernel
pair of :mod:`ray_tpu_torch.ops.flash_attention`, ``"xla"`` the plain
masked-softmax einsums. The training state is updated in place (the
parameters and the optimizer's moments), where the reference returns a
new pytree.

``n_experts > 0`` replaces every block's FFN by the Mixture-of-Experts
FFN of :mod:`ray_tpu_torch.models.moe` (router, top-k gating with a
static capacity, batched expert products), as the reference's
``_block`` does; :func:`forward` sums the blocks' load-balance terms and
:func:`loss_fn` adds ``moe_aux_coef`` times that sum. Expert parallelism
(the reference's ``ep_axis``) is not ported: the port has no mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._private import prng
from .._private.device import (DeviceLike, resolve_device,
                               set_matmul_precision)
from ..ops.flash_attention import flash_attention
from ..ops.flash_attention import supported as flash_supported

Params = Dict[str, torch.Tensor]

#: Per-layer weights, stacked along a leading ``[n_layer]`` axis.
BLOCK_PARAMS = ("ln1_scale", "ln2_scale", "wq", "wk", "wv", "wo", "w1",
                "w2")
#: The same for an MoE model: ``router [L, d, E]``, ``w_up [L, E, d,
#: f]`` and ``w_down [L, E, f, d]`` in place of ``w1``/``w2``.
MOE_BLOCK_PARAMS = BLOCK_PARAMS[:6] + ("router", "w_up", "w_down")


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
    remat: Any = "dots"              # none|dots|full (bool accepted)
    attn_backend: str = "auto"       # auto | xla | flash
    n_experts: int = 0               # >0 → MoE FFN in every block
    expert_top_k: int = 2            # tokens routed to k experts
    capacity_factor: float = 1.25    # per-expert slots = cf*k*T/E
    moe_aux_coef: float = 0.01       # load-balance loss weight
    loss_chunk: int = 0              # seq chunk for cross-entropy (0=off):
    # only one chunk's f32 [B, chunk, vocab] logits are live at a time and
    # backward re-projects them (``gpt.py:55``); needed where the whole
    # logits tensor would not fit (the 1b preset).

    def __post_init__(self):
        if self.n_experts < 0 or (self.n_experts > 0 and not
                                  1 <= self.expert_top_k <= self.n_experts):
            raise ValueError(
                f"n_experts={self.n_experts}, expert_top_k="
                f"{self.expert_top_k}: need 1 <= top_k <= n_experts")
        if self.attn_backend in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_backend={self.attn_backend!r} (sequence-parallel "
                f"attention) is not ported yet: ROADMAP.md Queue 1, "
                f"parallel/")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}")
        if _remat_policy(self.remat) not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layer
        per_layer = 4 * d * d + 2 * d * f + 2 * d  # qkv,o + mlp + 2 ln scales
        return v * d + self.max_seq * d + L * per_layer + d

    def flops_per_token(self) -> int:
        # 6ND approximation per forward+backward token.
        return 6 * self.num_params()


REMAT_POLICIES = ("none", "dots", "full")
ATTN_BACKENDS = ("auto", "xla", "flash")


def _remat_policy(remat) -> str:
    """The reference's ``{True: "full", False: "none"}`` bool mapping."""
    if remat is True:
        return "full"
    if remat is False:
        return "none"
    return remat


# sizes used by benchmarks / examples (ray_tpu/models/gpt.py:79)
CONFIGS = {
    "nano": GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=64,
                      d_ff=256, max_seq=128),
    "small": GPTConfig(),                                   # GPT-2 124M
    "medium": GPTConfig(n_layer=24, n_head=16, d_model=1024, d_ff=4096),
    "1b": GPTConfig(n_layer=24, n_head=16, d_model=2048, d_ff=8192,
                    max_seq=2048, loss_chunk=256),
}


def init_params(cfg: GPTConfig, seed: int = 0, device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's random weights for ``jax.random.PRNGKey(seed)``
    (``gpt.py:89-137``), bit for bit: the same key schedule (``split(key,
    8)``; each stacked weight from ``split(keys[i], n_layer)``, one draw
    per layer) and the same float32 ``normal * scale`` draws, through the
    port's threefry (:func:`ray_tpu_torch._private.prng.normal`), made on
    ``device``. ``dtype`` is the storage dtype (default
    ``cfg.param_dtype``); every draw is cast to it once, and storing in
    the compute dtype changes no result, since every use casts to it
    first. An MoE config draws ``router``, ``w_up`` and ``w_down`` as
    ``gpt.py:114-127`` does: from ``split(keys[6], 3)``, each expert's
    key split per layer and then per expert, ``keys[7]`` unused; the
    experts one layer at a time, so the draw's temporaries stay the
    size of one layer's experts."""
    dev = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    root = torch.from_numpy(prng.PRNGKey(seed).astype(np.int64)).to(dev)
    keys = prng.split(root, 8)

    def draw(key, shape, scale=None):
        # _dense_init: normal * (scale or 1/sqrt(fan_in)), in float32.
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0])
        return (prng.normal(key, shape) * float(np.float32(scale))
                ).to(dtype)

    def stack(key, shape, scale=None):
        # [L] layer keys draw [L, *shape] at once: each lane hashes its
        # own key over the same counter, as one draw per layer does.
        return draw(prng.split(key, L), shape, scale)

    def stack_e(key, shape, scale=None):
        # [L, E] keys: split per layer, then per expert.
        E = cfg.n_experts
        kk = prng.split(prng.split(key, L), E)
        out = torch.empty(L, E, *shape, dtype=dtype, device=dev)
        for i in range(L):
            out[i] = draw(kk[i], shape, scale)
        return out

    resid = 1.0 / math.sqrt(2 * L * d)
    params = {
        "embed": draw(keys[0], (cfg.vocab_size, d), 0.02),
        "pos_embed": draw(keys[1], (cfg.max_seq, d), 0.01),
        "ln1_scale": torch.ones(L, d, dtype=dtype, device=dev),
        "ln2_scale": torch.ones(L, d, dtype=dtype, device=dev),
        "wq": stack(keys[2], (d, d)),
        "wk": stack(keys[3], (d, d)),
        "wv": stack(keys[4], (d, d)),
        "wo": stack(keys[5], (d, d), resid),
    }
    if cfg.n_experts > 0:
        ks = prng.split(keys[6], 3)
        params["router"] = stack(ks[0], (d, cfg.n_experts), 0.02)
        params["w_up"] = stack_e(ks[1], (d, f))
        params["w_down"] = stack_e(ks[2], (f, d), resid)
    else:
        params["w1"] = stack(keys[6], (d, f))
        params["w2"] = stack(keys[7], (f, d), resid)
    params["ln_f_scale"] = torch.ones(d, dtype=dtype, device=dev)
    return params


def params_from_numpy(tree: Mapping, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> Params:
    """The reference's params pytree (``ray_tpu.models.gpt.init_params``,
    leaves already converted to numpy by the caller) → the port's flat
    dict of stacked tensors, ``[in, out]`` kernel layout kept; an MoE
    tree's ``router``/``w_up``/``w_down`` included."""
    dev = resolve_device(device)
    blk = tree["block"]

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=dtype)

    out = {"embed": t(tree["embed"]["kernel"]),
           "pos_embed": t(tree["pos_embed"]),
           "ln_f_scale": t(tree["ln_f_scale"])}
    for name in block_names(blk):
        leaf = blk[name]
        out[name] = t(leaf["kernel"] if isinstance(leaf, Mapping) else leaf)
    return out


def block_names(params: Mapping) -> Tuple[str, ...]:
    """The per-layer weight names of ``params`` (or of a reference
    ``block`` tree): :data:`MOE_BLOCK_PARAMS` if it has a router, else
    :data:`BLOCK_PARAMS`."""
    return MOE_BLOCK_PARAMS if "router" in params else BLOCK_PARAMS


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights (views into the stacked tensors)."""
    return {name: params[name][i] for name in block_names(params)}


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


def _mm_row(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
            group=None) -> torch.Tensor:
    """Row-parallel :func:`_mm` (``gpt_decode.py:206``): the f32 product
    of the compute-dtype operands (upcast, exact), summed over ``group``
    (a :mod:`~ray_tpu_torch._private.tp` rank's collectives) in f32,
    then ONE cast, the cast point of :func:`_mm`. With ``group=None``
    this IS ``_mm``, bit for bit."""
    if group is None:
        return _mm(x, w, dtype)
    out = torch.matmul(x.to(dtype).float(), w.to(dtype).float())
    return group.all_reduce(out).to(dtype)


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


def _resolve_attn_backend(cfg: GPTConfig, q: torch.Tensor) -> str:
    """``auto`` → ``flash`` on CUDA tensors the kernels take, else
    ``xla`` (the reference resolves ``auto`` to xla off the TPU). A CUDA
    tensor the kernels do not take warns that attention runs the plain
    einsums on the card, so such a run is not mistaken for a kernel run."""
    if cfg.attn_backend != "auto":
        return cfg.attn_backend
    if q.device.type == "cuda":
        if flash_supported(q):
            return "flash"
        warnings.warn(
            f"attn_backend='auto': the flash kernels do not take {q.dtype} "
            f"head_dim {q.shape[-1]}; attention runs the plain einsums "
            f"on the card", stacklevel=2)
    return "xla"


def _attention(q, k, v, cfg: GPTConfig) -> torch.Tensor:
    """[B, S, H, hd] causal attention by the configured backend
    (``gpt.py:194``). ``flash`` on CUDA tensors launches the kernels or
    raises."""
    if _resolve_attn_backend(cfg, q) == "flash":
        return flash_attention(q, k, v, causal=True)
    return _attention_xla(q, k, v, cfg)


def _ffn(h: torch.Tensor, p: Params, cfg: GPTConfig, aux: bool = True,
         group=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed ``h`` → (y, load-balance term):
    the MoE FFN when ``cfg.n_experts > 0`` (its term ``None`` with
    ``aux=False``), else the dense GELU MLP (term ``None``). Under a
    tensor-parallel ``group`` (dense only) ``w1`` is this rank's column
    slice and ``w2`` reduces through :func:`_mm_row`."""
    if cfg.n_experts > 0:
        from .moe import moe_ffn

        return moe_ffn(h, p["router"], p["w_up"], p["w_down"],
                       top_k=cfg.expert_top_k,
                       capacity_factor=cfg.capacity_factor,
                       dtype=cfg.dtype, aux=aux)
    return _mm_row(_gelu(_mm(h, p["w1"], cfg.dtype)), p["w2"], cfg.dtype,
                   group), None


def _block(x: torch.Tensor, p: Params, cfg: GPTConfig
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One transformer block → (x, aux) (``gpt.py:234``): ``aux`` is the
    MoE load-balance term, ``None`` for a dense FFN (the reference's 0)."""
    B, S, d = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    h = _rmsnorm(x, p["ln1_scale"])
    q = _mm(h, p["wq"], cfg.dtype).reshape(B, S, H, hd)
    k = _mm(h, p["wk"], cfg.dtype).reshape(B, S, H, hd)
    v = _mm(h, p["wv"], cfg.dtype).reshape(B, S, H, hd)
    att = _attention(q, k, v, cfg).reshape(B, S, d)
    x = x + _mm(att, p["wo"], cfg.dtype)
    y, aux = _ffn(_rmsnorm(x, p["ln2_scale"]), p, cfg)
    return x + y, aux


# Matrix products: what ``jax.checkpoint_policies.checkpoint_dots`` keeps.
# ``matmul``/``einsum`` reach the dispatcher as these.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, policy: str, *args):
    """``fn(*args)`` under the remat policy (``gpt.py:364-373``): ``full``
    recomputes everything in backward, ``dots`` keeps matrix-product
    outputs and recomputes the rest (the flash kernel is not a product, so
    its forward runs again), ``none`` saves every activation. Without
    autograd there is nothing to save, and ``fn`` just runs."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _save_dots))


def forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig, *,
            return_aux: bool = False, final_hidden: bool = False):
    """tokens [B, S] int → logits [B, S, vocab] float32
    (``gpt.py:344``). ``return_aux`` also returns ``{"moe_aux": the
    layers' load-balance terms summed}`` (0 for a dense model).
    ``final_hidden`` skips the vocab projection and returns the
    post-norm hidden states (the chunked loss projects per chunk
    itself)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    S = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    x = x + params["pos_embed"][:S].to(cfg.dtype)[None]
    policy = _remat_policy(cfg.remat)
    auxs = []
    for i in range(cfg.n_layer):
        x, aux = _remat(_block, policy, x, layer_params(params, i), cfg)
        if aux is not None:
            auxs.append(aux)
    x = _rmsnorm(x, params["ln_f_scale"])
    out = x if final_hidden else _project_vocab(x, params["embed"], cfg)
    if not return_aux:
        return out
    aux = torch.stack(auxs).sum() if auxs else torch.zeros(
        (), dtype=torch.float32, device=x.device)
    return out, {"moe_aux": aux}


def _ce_from_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    return -ll.mean()


def _chunk_ce_sum(xc, embed, tc, cfg: GPTConfig) -> torch.Tensor:
    return _ce_from_logits(_project_vocab(xc, embed, cfg), tc) * tc.numel()


def _chunked_ce(x, embed, targets, cfg: GPTConfig) -> torch.Tensor:
    """Cross-entropy over the vocab projection in sequence chunks of
    ``cfg.loss_chunk`` (``gpt.py:448``): each chunk is checkpointed, so
    only one chunk's f32 logits are live and backward re-projects. A
    ragged tail is one more, unchunked, piece."""
    B, S, _ = x.shape
    chunk = cfg.loss_chunk
    n = S // chunk
    if n == 0:
        n, chunk = 1, S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + _remat(_chunk_ce_sum, "full", x[:, sl], embed,
                               targets[:, sl], cfg)
    if S > n * chunk:
        total = total + _chunk_ce_sum(x[:, n * chunk:], embed,
                                      targets[:, n * chunk:], cfg)
    return total / (B * S)


def loss_fn(params: Params, batch: Mapping, cfg: GPTConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (``gpt.py:476``). batch: ``tokens``
    [B, S+1], or ``tokens`` and ``targets`` [B, S]. Returns (loss,
    {"loss", "perplexity"}), the metrics detached. An MoE model adds
    ``moe_aux_coef`` times the load-balance term to the loss and reports
    the term as ``metrics["moe_aux"]`` (``gpt.py:492-494``); ``loss``
    and ``perplexity`` stay the cross-entropy's."""
    dev = params["embed"].device
    if "targets" in batch:
        tokens, targets = batch["tokens"], batch["targets"]
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
    else:
        full = torch.as_tensor(batch["tokens"], device=dev)
        tokens, targets = full[:, :-1], full[:, 1:]
    if cfg.loss_chunk:
        x, aux = forward(params, tokens, cfg, return_aux=True,
                         final_hidden=True)
        loss = _chunked_ce(x, params["embed"], targets, cfg)
    else:
        logits, aux = forward(params, tokens, cfg, return_aux=True)
        loss = _ce_from_logits(logits, targets)
    done = loss.detach()
    metrics = {"loss": done, "perplexity": torch.exp(done)}
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"].detach()
    return loss, metrics


#: ``optax.adamw(3e-4, weight_decay=0.01)`` as the reference's
#: ``make_train_step`` builds it (optax's b1, b2, eps defaults); decay on
#: every parameter, as optax with no mask.
ADAMW_DEFAULTS = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=0.01)


def _default_optimizer(params: Iterable[torch.Tensor]
                       ) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, **ADAMW_DEFAULTS)


def make_train_step(cfg: GPTConfig, optimizer: Optional[Callable[
        [Iterable[torch.Tensor]], torch.optim.Optimizer]] = None, *,
        device: DeviceLike = None):
    """(init, step) for single-card training (``gpt.py:499``).

    - ``init(seed=0, params=None)`` → ``{"params", "opt", "step"}``:
      f32 master parameters (seeded :func:`init_params`, or a copy of
      ``params``, e.g. :func:`params_from_numpy`'s) and the optimizer
      ``optimizer(params)`` builds (default ``torch.optim.AdamW`` with
      :data:`ADAMW_DEFAULTS`).
    - ``step(state, batch)`` → ``(state, {"loss", "perplexity"})``
      (and ``"moe_aux"`` for an MoE model, as :func:`loss_fn`): one
      forward/backward/update; parameters and optimizer state are
      updated in place. The forward casts the master parameters to
      ``cfg.dtype``.

    The mesh, sharding rules and donation of the reference are not
    ported (ROADMAP.md Queue 1, ``parallel/``)."""
    dev = resolve_device(device)
    set_matmul_precision(dev)
    make_opt = optimizer or _default_optimizer

    def init(seed: int = 0, params: Optional[Params] = None) -> Dict:
        if params is None:
            params = init_params(cfg, seed, dev)
        params = {k: t.detach().to(device=dev, dtype=cfg.param_dtype)
                  .clone().requires_grad_(True) for k, t in params.items()}
        return {"params": params, "opt": make_opt(list(params.values())),
                "step": 0}

    def step(state: Dict, batch: Mapping) -> Tuple[Dict, Dict]:
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state["params"], batch, cfg)
        loss.backward()
        opt.step()
        return ({"params": state["params"], "opt": opt,
                 "step": state["step"] + 1}, metrics)

    return init, step


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
