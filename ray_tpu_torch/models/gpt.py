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
:func:`make_train_step` (``torch.optim.AdamW``) on one card or over a
:class:`~ray_tpu_torch.parallel.mesh.Mesh` of ranks (below). Attention
goes through :func:`_attention`: ``"flash"`` is the hand-written kernel
pair of :mod:`ray_tpu_torch.ops.flash_attention`, ``"xla"`` the plain
masked-softmax einsums, ``"ring"``/``"ulysses"`` the sequence-parallel
attention of :mod:`ray_tpu_torch.ops.ring_attention` over the mesh's
``cfg.sp_axis``. The training state is updated in place (the
parameters and the optimizer's moments), where the reference returns a
new pytree.

**Sharded training.** The reference jits one step over a mesh and lets
GSPMD place the work. The port runs one process per rank, each the
same step over its shard (``torchrun``'s model):

- storage follows the rules' placements (``LM_RULES`` by default, the
  leaves' paths from :data:`PARAM_PATHS`): each rank keeps its shard
  of every parameter and of its AdamW moments;
- each step gathers the parameters, takes this rank's rows of the
  global batch (``dp`` x ``fsdp``) and, under ``sp``, its sequence
  chunk; under ``tp`` each rank computes its heads and its slice of the
  FFN (Megatron: column-parallel ``wq/wk/wv/w1``, row-parallel
  ``wo/w2`` whose f32 partials are summed by an all-reduce), so the
  flash kernels run on every rank at ``[B/(dp*fsdp), S, H/tp, hd]``;
- the gradients are summed over the ranks, reduce-scattered to each
  rank's shard and averaged over the data ranks, and AdamW updates the
  shards.

**Pipeline** (``cfg.pp_axis`` on the mesh; ``gpt.py:376-421``): each
rank stores and runs only its stage's layers (``PP_LM_RULES``), through
the GPipe schedule of :mod:`ray_tpu_torch.parallel.pipeline` with
``cfg.num_microbatches`` microbatches (default ``2 * pp``). Inside a
stage the block is the remat'ed :func:`_block` (pp alone, with dp or
fsdp rows), :func:`_block_pp_tp` (Megatron over tp) or
:func:`_block_pp_sp` (ring attention over sp), as in the reference.
Stage 0 embeds; only the last stage runs the final norm, the tied vocab
projection and the loss, and broadcasts the metrics; every gradient
outside the blocks is then summed over the stages (``embed``: stage 0's
input part plus the last stage's head part).

``n_experts > 0`` replaces every block's FFN by the Mixture-of-Experts
FFN of :mod:`ray_tpu_torch.models.moe` (router, top-k gating with a
static capacity, batched expert products), as the reference's
``_block`` does; :func:`forward` sums the blocks' load-balance terms and
:func:`loss_fn` adds ``moe_aux_coef`` times that sum. On a mesh MoE runs
over dp, fsdp, tp, sp (ring or Ulysses attention) and the expert axis
``cfg.ep_axis``: rows split over dp x fsdp, sequence chunks over sp,
both replicated over ep and tp; each ep rank holds ``E/ep`` experts and
each tp rank ``d_ff/tp`` of every expert's hidden units; capacity,
slots and the balance term count the global batch in the reference's
token order, as its GSPMD step does
(:func:`ray_tpu_torch.models.moe.moe_ffn`). MoE in a pipeline raises,
as in the reference.
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
    attn_backend: str = "auto"       # auto | xla | flash | ring | ulysses
    sp_axis: Optional[str] = None    # mesh axis for ring/ulysses attention
    pp_axis: Optional[str] = None    # mesh axis for pipeline parallelism
    num_microbatches: int = 0        # pp microbatches (0 → 2 * pp size)
    n_experts: int = 0               # >0 → MoE FFN in every block
    expert_top_k: int = 2            # tokens routed to k experts
    capacity_factor: float = 1.25    # per-expert slots = cf*k*T/E
    moe_aux_coef: float = 0.01       # load-balance loss weight
    ep_axis: Optional[str] = "ep"    # mesh axis sharding the expert dim
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
ATTN_BACKENDS = ("auto", "xla", "flash", "ring", "ulysses")


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
    return {name: torch.from_numpy(np.array(x, np.float32)).to(
        device=dev, dtype=dtype) for name, x in params_flat(tree).items()}


#: Each weight's path in the reference's params pytree: what the
#: sharding rules match (``ray_tpu/parallel/sharding.py:91``) and what
#: orders the leaves of an npz checkpoint.
PARAM_PATHS = {"embed": "embed/kernel", "pos_embed": "pos_embed",
               "ln_f_scale": "ln_f_scale", "ln1_scale": "block/ln1_scale",
               "ln2_scale": "block/ln2_scale",
               **{n: f"block/{n}/kernel" for n in (
                   "wq", "wk", "wv", "wo", "w1", "w2", "router", "w_up",
                   "w_down")}}


def params_tree(params: Mapping) -> Dict:
    """The port's flat dict in the reference's nested layout (the same
    leaf objects, at :data:`PARAM_PATHS`)."""
    out: Dict = {}
    for name, leaf in params.items():
        *head, last = PARAM_PATHS[name].split("/")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def params_flat(tree: Mapping) -> Dict[str, Any]:
    """The inverse of :func:`params_tree`: the reference's params tree's
    leaves under the port's names (an MoE tree's router and experts
    included)."""
    out = {}
    for name, path in PARAM_PATHS.items():
        node = tree
        for key in path.split("/"):
            node = node.get(key) if isinstance(node, Mapping) else None
        if node is not None:
            out[name] = node
    return out


def param_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Every weight's full shape, as :func:`init_params` draws it."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    shapes = {"embed": (cfg.vocab_size, d), "pos_embed": (cfg.max_seq, d),
              "ln1_scale": (L, d), "ln2_scale": (L, d),
              **{n: (L, d, d) for n in ("wq", "wk", "wv", "wo")}}
    if cfg.n_experts > 0:
        E = cfg.n_experts
        shapes.update(router=(L, d, E), w_up=(L, E, d, f),
                      w_down=(L, E, f, d))
    else:
        shapes.update(w1=(L, d, f), w2=(L, f, d))
    shapes["ln_f_scale"] = (d,)
    return shapes


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


@dataclasses.dataclass(frozen=True)
class _Par:
    """This rank's share of a sharded forward: the tensor-parallel group
    (``None`` at tp=1), the sequence-parallel group with this rank's
    index along it (``None`` at sp=1, or off a mesh), the pipeline group
    and its microbatch count (``None`` off a pipeline), and for MoE the
    expert-parallel group and the routing group over the data axes and
    sp (``None`` where the axes have one rank) with each routing rank's
    (row chunk, sequence chunk) in ``blocks``."""

    tp: Any = None
    sp: Any = None
    sp_axis: Optional[str] = None
    pp: Any = None
    microbatches: int = 0
    ep: Any = None
    data: Any = None
    blocks: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def pieces(self) -> bool:
        """Whether a block holds collectives, so that remat must wrap
        its pieces between them rather than the whole block."""
        return any(g is not None for g in (self.tp, self.sp, self.ep,
                                           self.data))


_SOLO = _Par()


def _pipelined(cfg: GPTConfig, mesh) -> bool:
    """Whether ``cfg`` runs a pipeline on ``mesh`` (``gpt.py:376``)."""
    return bool(cfg.pp_axis) and mesh is not None and \
        cfg.pp_axis in mesh.shape and mesh.size > 1


def _ep_axis(cfg: GPTConfig, mesh) -> Optional[str]:
    """The axis that shards an MoE model's experts on ``mesh``, if any."""
    if cfg.n_experts > 0 and cfg.ep_axis and \
            mesh.shape.get(cfg.ep_axis, 1) > 1:
        return cfg.ep_axis
    return None


def _check_pp(cfg: GPTConfig, mesh) -> None:
    """The pipeline branch's refusals (``gpt.py:377-410``,
    ``pipeline.py:72-83``)."""
    from ..parallel.pipeline import check_mesh

    sizes = mesh.shape
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE inside a pipeline stage is not supported yet; use an "
            "{ep, dp} mesh for expert parallelism")
    tp_ax = "tp" if "tp" in sizes else None
    sp_ax = cfg.sp_axis if cfg.sp_axis and cfg.sp_axis in sizes else None
    if tp_ax is not None and sp_ax is not None:
        raise NotImplementedError(
            "pp x tp x sp on one mesh is not supported; pick two")
    check_mesh(mesh, cfg.pp_axis, tp_ax, sp_ax)
    tp = sizes.get("tp", 1)
    if cfg.n_head % tp or cfg.d_ff % tp:
        raise ValueError(f"n_head={cfg.n_head} / d_ff={cfg.d_ff} not "
                         f"divisible by tp={tp}")
    if cfg.n_layer % sizes[cfg.pp_axis]:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by "
                         f"{cfg.pp_axis}={sizes[cfg.pp_axis]}")
    extra = [a for a, n in sizes.items() if n > 1 and a not in (
        cfg.pp_axis, "dp", "fsdp", "tp", sp_ax)]
    if extra:
        raise ValueError(f"mesh axes {extra} shard nothing in a pipeline "
                         f"of a dense model")


def _check(cfg: GPTConfig, mesh) -> None:
    """Whether ``cfg`` runs on ``mesh`` (``gpt.py:376-423``'s checks):
    dp/fsdp/tp/sp for a dense model, and for MoE with ``cfg.ep_axis``
    beside them; a pipeline over ``cfg.pp_axis`` with tp or sp inside a
    stage (dense only). Raises where the reference raises."""
    sizes = mesh.shape
    seq = cfg.attn_backend in ("ring", "ulysses")
    if seq and (not cfg.sp_axis or cfg.sp_axis not in sizes):
        raise ValueError(
            f"attn_backend={cfg.attn_backend!r} needs a mesh with the sp "
            f"axis {cfg.sp_axis!r}; pass mesh via make_train_step")
    if mesh.size == 1:
        return
    if _pipelined(cfg, mesh):
        return _check_pp(cfg, mesh)
    tp = sizes.get("tp", 1)
    if cfg.n_experts > 0:
        ep = sizes.get(cfg.ep_axis, 1) if cfg.ep_axis else 1
        if cfg.n_experts % ep:
            raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                             f"{cfg.ep_axis}={ep}")
    if cfg.n_head % tp or cfg.d_ff % tp:
        raise ValueError(f"n_head={cfg.n_head} / d_ff={cfg.d_ff} not "
                         f"divisible by tp={tp}")
    used = ("dp", "fsdp", "tp") if cfg.n_experts == 0 else \
        ("dp", "fsdp", "tp", cfg.ep_axis)
    extra = [a for a, n in sizes.items() if n > 1 and a not in used
             and not (seq and a == cfg.sp_axis)]
    if extra:
        raise ValueError(f"mesh axes {extra} shard nothing under "
                         f"attn_backend={cfg.attn_backend!r} (an sp axis "
                         f"needs ring or ulysses attention, a pp axis "
                         f"cfg.pp_axis, an ep axis an MoE model)")
    sp_n = sizes.get(cfg.sp_axis, 1) if seq else 1
    if cfg.attn_backend == "ulysses" and (cfg.n_head // tp) % sp_n:
        raise ValueError(f"ulysses needs the {cfg.n_head // tp} heads of a "
                         f"tp rank divisible by sp={sp_n}")


def _par(cfg: GPTConfig, mesh) -> _Par:
    """The groups ``cfg`` runs over on ``mesh`` (checked by
    :func:`_check`)."""
    if mesh is None:
        return _SOLO
    _check(cfg, mesh)
    seq = cfg.attn_backend in ("ring", "ulysses")
    sizes = mesh.shape

    def group(axis):
        return mesh.group(axis) if mesh.size > 1 and axis and \
            sizes.get(axis, 1) > 1 else None

    if _pipelined(cfg, mesh):
        sp_ax = cfg.sp_axis if cfg.sp_axis in sizes else None
        return _Par(tp=group("tp"), sp=group(sp_ax), sp_axis=sp_ax,
                    pp=mesh.group(cfg.pp_axis),
                    microbatches=cfg.num_microbatches)
    sp = group(cfg.sp_axis) if seq else None
    par = _Par(tp=group("tp"), sp=sp, sp_axis=cfg.sp_axis if seq else None)
    if cfg.n_experts == 0 or mesh.size == 1:
        return par
    # MoE routes over the ranks that hold other tokens: rows over the data
    # axes, and under sp each row's sequence chunks.
    rows = tuple(a for a in ("dp", "fsdp") if sizes.get(a, 1) > 1)
    axes = rows + ((cfg.sp_axis,) if sp is not None else ())
    data = blocks = None
    if axes:
        data = mesh.group(axes)
        at = [mesh.ranks.index(g) for g in data.ranks]
        blocks = tuple((mesh.index(rows, i), mesh.coords(i)[cfg.sp_axis]
                        if sp is not None else 0) for i in at)
    return dataclasses.replace(par, ep=group(_ep_axis(cfg, mesh)),
                               data=data, blocks=blocks)


def _attention(q, k, v, cfg: GPTConfig, par: _Par = _SOLO) -> torch.Tensor:
    """[B, S, H, hd] causal attention by the configured backend
    (``gpt.py:194``). ``flash`` on CUDA tensors launches the kernels or
    raises; on a mesh each rank runs it on its rows and heads, as the
    reference's ``shard_map`` does. ``ring``/``ulysses`` run over the
    sp group on this rank's sequence chunk."""
    backend = _resolve_attn_backend(cfg, q)
    if backend == "flash":
        return flash_attention(q, k, v, causal=True)
    if backend in ("ring", "ulysses"):
        if par.sp_axis is None:
            raise ValueError(
                f"attn_backend={backend!r} needs a mesh with the sp axis "
                f"{cfg.sp_axis!r}; pass mesh via make_train_step")
        from ..ops import ring_attention as ra

        fn = ra.ring_attention if backend == "ring" else ra.ulysses_attention
        return fn(q, k, v, group=par.sp, causal=True)
    return _attention_xla(q, k, v, cfg)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the tp group in
    f32 (Megatron's ``f``: the replicated input of column-parallel
    products)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.group.allreduce(g.float()).to(g.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """Sums the f32 partials of row-parallel products over the tp group;
    identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.allreduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ffn(h: torch.Tensor, p: Params, cfg: GPTConfig, aux: bool = True,
         group=None, par: _Par = _SOLO, piece: Optional[Callable] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed ``h`` → (y, load-balance term):
    the MoE FFN when ``cfg.n_experts > 0`` (its term ``None`` with
    ``aux=False``; on a mesh over ``par.ep``, ``par.tp`` and the routing
    group ``par.data``, each piece between collectives run by ``piece``),
    else the dense GELU MLP (term ``None``). Under a tensor-parallel
    ``group`` (dense only) ``w1`` is this rank's column slice and ``w2``
    reduces through :func:`_mm_row`."""
    if cfg.n_experts > 0:
        from .moe import moe_ffn

        return moe_ffn(h, p["router"], p["w_up"], p["w_down"],
                       top_k=cfg.expert_top_k,
                       capacity_factor=cfg.capacity_factor,
                       dtype=cfg.dtype, aux=aux, ep=par.ep, tp=par.tp,
                       data=par.data, blocks=par.blocks, piece=piece)
    return _mm_row(_gelu(_mm(h, p["w1"], cfg.dtype)), p["w2"], cfg.dtype,
                   group), None


def _block(x: torch.Tensor, p: Params, cfg: GPTConfig, par: _Par = _SOLO
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One transformer block → (x, aux) (``gpt.py:234``): ``aux`` is the
    MoE load-balance term, ``None`` for a dense FFN (the reference's 0)."""
    B, S, d = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    h = _rmsnorm(x, p["ln1_scale"])
    q = _mm(h, p["wq"], cfg.dtype).reshape(B, S, H, hd)
    k = _mm(h, p["wk"], cfg.dtype).reshape(B, S, H, hd)
    v = _mm(h, p["wv"], cfg.dtype).reshape(B, S, H, hd)
    att = _attention(q, k, v, cfg, par).reshape(B, S, d)
    x = x + _mm(att, p["wo"], cfg.dtype)
    y, aux = _ffn(_rmsnorm(x, p["ln2_scale"]), p, cfg, par=par)
    return x + y, aux


def _block_pp_tp(x: torch.Tensor, p: Params, cfg: GPTConfig, tp
                 ) -> torch.Tensor:
    """A pipeline stage's block under tensor parallelism
    (``gpt.py:265-296``): this rank's ``n_head/tp`` heads and ``d_ff/tp``
    hidden units (column-parallel ``wq/wk/wv/w1``), row-parallel
    ``wo``/``w2`` whose partials are summed over the tp group. As in the
    reference each partial is cast to the compute dtype BEFORE its sum
    (``:287-289``, ``:293-295``; the non-pp tp path sums f32 partials,
    :func:`_reduced`); the sum runs in f32 and is cast once, which for
    two ranks is the reference's compute-dtype ``psum`` and needs no
    bf16 reduction from the transport. Attention is the flash kernels or
    the plain einsums, never ring; no remat, as in the reference."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p["ln1_scale"], p["wq"], p["wk"], p["wv"], cfg, tp)
    if _resolve_attn_backend(cfg, q) == "flash":
        att = flash_attention(q, k, v, causal=True)
    else:
        att = _attention_xla(q, k, v, cfg)
    x = x + _psum_cast(_mm(att.reshape(B, S, -1), p["wo"], cfg.dtype),
                       cfg, tp)
    h = _rmsnorm(x, p["ln2_scale"])
    if tp is not None:
        h = _CopyToTP.apply(h, tp)
    y = _mm(_gelu(_mm(h, p["w1"], cfg.dtype)), p["w2"], cfg.dtype)
    return x + _psum_cast(y, cfg, tp)


def _psum_cast(y: torch.Tensor, cfg: GPTConfig, tp) -> torch.Tensor:
    """The compute-dtype partials ``y`` summed over ``tp`` (f32 sum, one
    cast); ``y`` itself at tp=1."""
    return y if tp is None else \
        _ReduceFromTP.apply(y.float(), tp).to(cfg.dtype)


def _block_pp_sp(x: torch.Tensor, p: Params, cfg: GPTConfig, sp
                 ) -> torch.Tensor:
    """A pipeline stage's block under sequence parallelism
    (``gpt.py:299-319``): ``x`` is this rank's ``[B, S/sp, d]`` chunk and
    attention is always ring attention over the sp group, whatever
    ``attn_backend`` says; no remat, as in the reference."""
    from ..ops import ring_attention as ra

    B, S, d = x.shape
    q, k, v = _qkv(x, p["ln1_scale"], p["wq"], p["wk"], p["wv"], cfg, None)
    att = ra.ring_attention(q, k, v, group=sp, causal=True)
    x = x + _mm(att.reshape(B, S, d), p["wo"], cfg.dtype)
    h = _rmsnorm(x, p["ln2_scale"])
    return x + _mm(_gelu(_mm(h, p["w1"], cfg.dtype)), p["w2"], cfg.dtype)


def _pp_tp_param_specs(names: Iterable[str], pp_axis: str,
                       tp_axis: Optional[str]):
    """Each stacked block weight's :class:`~ray_tpu_torch.parallel.
    sharding.PartitionSpec` under pp x tp (``gpt.py:322-341``): the
    layer dim over ``pp_axis``; column weights (``wq/wk/wv/w1``) split
    their output dim over ``tp_axis``, row weights (``wo/w2``) their
    input dim. A rank's compute slice of the full stack is the spec's
    shard (:func:`compute_params`)."""
    from ..parallel.sharding import PartitionSpec as P
    from .gpt_decode import _TP_COL, _TP_ROW  # that module imports this

    specs = {}
    for n in names:
        if tp_axis and n in _TP_COL:           # [L, d, out]
            specs[n] = P(pp_axis, None, tp_axis)
        elif tp_axis and n in _TP_ROW:
            specs[n] = P(pp_axis, tp_axis)
        else:
            specs[n] = P(pp_axis)
    return specs


def _qkv(x, ln, wq, wk, wv, cfg: GPTConfig, tp):
    """Column-parallel q, k, v ``[B, S, H/tp, hd]`` of the normed x."""
    h = _rmsnorm(x, ln)
    if tp is not None:
        h = _CopyToTP.apply(h, tp)
    B, S, _ = x.shape
    return tuple(_mm(h, w, cfg.dtype).reshape(B, S, -1, cfg.head_dim)
                 for w in (wq, wk, wv))


def _partial(a, w, cfg: GPTConfig, tp):
    """A row-parallel product before its sum over tp: f32 of the
    compute-dtype operands (:func:`_mm_row`'s cast point); :func:`_mm`
    at tp=1."""
    if tp is None:
        return _mm(a, w, cfg.dtype)
    return torch.matmul(a.to(cfg.dtype).float(), w.to(cfg.dtype).float())


def _mlp_partial(x, ln, w1, w2, cfg: GPTConfig, tp):
    h = _rmsnorm(x, ln)
    if tp is not None:
        h = _CopyToTP.apply(h, tp)
    return _partial(_gelu(_mm(h, w1, cfg.dtype)), w2, cfg, tp)


def _reduced(y, cfg: GPTConfig, tp):
    return y if tp is None else _ReduceFromTP.apply(y, tp).to(cfg.dtype)


def _block_pieces(x: torch.Tensor, p: Params, cfg: GPTConfig, par: _Par,
                  policy: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`_block` for a rank whose block holds collectives (tp
    all-reduces, ring or Ulysses exchanges, MoE's count all-gather and
    ep/tp sums): the remat policy wraps the pieces between them, so a
    recompute never repeats a collective. Flash attention is a piece of
    its own, recomputed under ``dots`` and ``full`` as in the
    whole-block form. The MoE FFN's pieces are the router, the expert
    products and the combine; the routing and the balance term, whose
    collectives sit between them, run once."""
    B, S, _ = x.shape
    q, k, v = _remat(_qkv, policy, x, p["ln1_scale"], p["wq"], p["wk"],
                     p["wv"], cfg, par.tp)
    if par.sp_axis is None:
        att = _remat(_attention, policy, q, k, v, cfg)
    else:
        att = _attention(q, k, v, cfg, par)
    x = x + _reduced(_remat(_partial, policy, att.reshape(B, S, -1),
                            p["wo"], cfg, par.tp), cfg, par.tp)
    if cfg.n_experts > 0:
        h = _remat(_rmsnorm, policy, x, p["ln2_scale"])
        y, aux = _ffn(h, p, cfg, par=par, piece=functools.partial(
            _remat_piece, policy))
        return x + y, aux
    return x + _reduced(_remat(_mlp_partial, policy, x, p["ln2_scale"],
                               p["w1"], p["w2"], cfg, par.tp), cfg,
                        par.tp), None


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


def _remat_piece(policy: str, fn: Callable, *args):
    return _remat(fn, policy, *args)


def _embed(params: Params, tokens: torch.Tensor, start: int,
           cfg: GPTConfig) -> torch.Tensor:
    S = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    return x + params["pos_embed"][start:start + S].to(cfg.dtype)[None]


def _trunk(params: Params, tokens, cfg: GPTConfig, par: _Par, mesh,
           to_all: bool = True):
    """The embedding and every block → (pre-norm activations, the
    blocks' load-balance terms). In a pipeline the activations are the
    last stage's (on every pp rank with ``to_all``, else there only; see
    :func:`~ray_tpu_torch.parallel.pipeline.pipeline_apply`)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    S = tokens.shape[1]
    start = par.sp.rank * S if par.sp is not None else 0
    policy = _remat_policy(cfg.remat)
    if par.pp is not None:
        return _stages(params, tokens, start, cfg, par, mesh, policy,
                       to_all), []
    x = _embed(params, tokens, start, cfg)
    auxs = []
    for i in range(cfg.n_layer):
        if par.pieces:
            x, aux = _block_pieces(x, layer_params(params, i), cfg, par,
                                   policy)
        else:
            x, aux = _remat(_block, policy, x, layer_params(params, i),
                            cfg, par)
        if aux is not None:
            auxs.append(aux)
    return x, auxs


def _stages(params: Params, tokens, start: int, cfg: GPTConfig, par: _Par,
            mesh, policy: str, to_all: bool) -> torch.Tensor:
    """The pipeline branch (``gpt.py:376-417``): stage 0 embeds, and the
    stage's block is :func:`_block_pp_tp` under tp, :func:`_block_pp_sp`
    under sp, else the remat'ed :func:`_block` on one rank's math."""
    from ..parallel.pipeline import pipeline_apply

    B, S = tokens.shape
    if par.pp.rank == 0:
        x = _embed(params, tokens, start, cfg)
    else:                        # only the shape and dtype are read
        x = torch.empty(B, S, cfg.d_model, dtype=cfg.dtype,
                        device=tokens.device)
    tp_ax = "tp" if "tp" in mesh.shape else None
    if tp_ax is not None:
        def block(a, lp):
            return _block_pp_tp(a, lp, cfg, par.tp)
    elif par.sp_axis is not None:
        def block(a, lp):
            return _block_pp_sp(a, lp, cfg, par.sp)
    else:
        def block(a, lp):
            return _remat(_block, policy, a, lp, cfg)[0]
    return pipeline_apply(
        block, {n: params[n] for n in block_names(params)}, x, mesh=mesh,
        pp_axis=cfg.pp_axis, num_microbatches=par.microbatches,
        tp_axis=tp_ax, sp_axis=par.sp_axis, to_all=to_all)


def forward(params: Params, tokens: torch.Tensor, cfg: GPTConfig,
            mesh=None, *, return_aux: bool = False,
            final_hidden: bool = False):
    """tokens [B, S] int → logits [B, S, vocab] float32
    (``gpt.py:344``). ``return_aux`` also returns ``{"moe_aux": the
    layers' load-balance terms summed}`` (0 for a dense model).
    ``final_hidden`` skips the vocab projection and returns the
    post-norm hidden states (the chunked loss projects per chunk
    itself).

    On a ``mesh`` of several ranks every rank calls this with its own
    share, as :func:`make_train_step`'s step does: ``params`` in this
    rank's compute layout (:func:`compute_params`: under pp its stage's
    layers, under ep its experts), ``tokens`` its rows of the batch and,
    under ring/ulysses attention or pp x sp, its chunk of the sequence
    (chunk ``i`` of the sp axis starts at position ``i * S``); the result
    is this rank's logits. In a pipeline every pp rank gets the last
    stage's result (broadcast from it, the reference's masked ``psum``)."""
    par = _par(cfg, mesh)
    x, auxs = _trunk(params, tokens, cfg, par, mesh)
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


def _data_axes(mesh, cfg: GPTConfig) -> Tuple[str, ...]:
    """The axes over which ranks see different tokens (rows over dp x
    fsdp; sequence chunks over the sp axis of ring/ulysses, and of a
    pipeline's pp x sp)."""
    axes = [a for a in ("dp", "fsdp") if mesh.shape.get(a, 1) > 1]
    if (cfg.attn_backend in ("ring", "ulysses") or _pipelined(cfg, mesh)) \
            and cfg.sp_axis and mesh.shape.get(cfg.sp_axis, 1) > 1:
        axes.append(cfg.sp_axis)
    return tuple(axes)


def _pp_loss(params: Params, tokens, targets, cfg: GPTConfig, par: _Par,
             mesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`loss_fn` in a pipeline: only the last stage runs the final
    norm, the tied vocab projection and the cross-entropy, and
    broadcasts the metrics over pp; the other stages return the 0-dim
    zero whose backward runs their share of the schedule."""
    h, _ = _trunk(params, tokens, cfg, par, mesh, to_all=False)
    last = par.pp.world_size - 1
    if par.pp.rank == last:
        x = _rmsnorm(h, params["ln_f_scale"])
        if cfg.loss_chunk:
            loss = _chunked_ce(x, params["embed"], targets, cfg)
        else:
            loss = _ce_from_logits(_project_vocab(x, params["embed"], cfg),
                                   targets)
        done = loss.detach()
    else:
        loss = h
        done = torch.zeros((), dtype=torch.float32, device=h.device)
    done = par.pp.broadcast(done, src_rank=last)
    axes = _data_axes(mesh, cfg)
    if axes:
        done = mesh.group(axes).allreduce(done) / mesh.size_of(axes)
    return loss, {"loss": done, "perplexity": torch.exp(done)}


def loss_fn(params: Params, batch: Mapping, cfg: GPTConfig, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (``gpt.py:476``). batch: ``tokens``
    [B, S+1], or ``tokens`` and ``targets`` [B, S]. Returns (loss,
    {"loss", "perplexity"}), the metrics detached. An MoE model adds
    ``moe_aux_coef`` times the load-balance term to the loss and reports
    the term as ``metrics["moe_aux"]`` (``gpt.py:492-494``); ``loss``
    and ``perplexity`` stay the cross-entropy's.

    On a ``mesh`` of several ranks ``batch`` is this rank's rows and
    ``params`` its compute layout (see :func:`forward`); under ring or
    ulysses attention the rank takes its chunk of the sequence itself.
    The returned loss is this rank's mean (what its backward needs); the
    metrics are the mean over every rank's tokens."""
    dev = params["embed"].device
    if "targets" in batch:
        tokens, targets = batch["tokens"], batch["targets"]
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
    else:
        full = torch.as_tensor(batch["tokens"], device=dev)
        tokens, targets = full[:, :-1], full[:, 1:]
    par = _par(cfg, mesh)
    if par.sp is not None:
        n, S = par.sp.world_size, tokens.shape[1]
        if S % n:
            raise ValueError(f"seq {S} not divisible by sp={n}")
        tokens, targets = (t.chunk(n, dim=1)[par.sp.rank]
                           for t in (tokens, targets))
    if par.pp is not None:
        return _pp_loss(params, tokens, targets, cfg, par, mesh)
    if cfg.loss_chunk:
        x, aux = forward(params, tokens, cfg, mesh, return_aux=True,
                         final_hidden=True)
        loss = _chunked_ce(x, params["embed"], targets, cfg)
    else:
        logits, aux = forward(params, tokens, cfg, mesh, return_aux=True)
        loss = _ce_from_logits(logits, targets)
    done = loss.detach()
    axes = _data_axes(mesh, cfg) if mesh is not None else ()
    if axes:
        done = mesh.group(axes).allreduce(done) / mesh.size_of(axes)
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


def _tp_dim(name: str, ndim: int, tp: int) -> Optional[int]:
    """The dim along which weight ``name`` is split into the tp ranks'
    compute slices (``gpt_decode.shard_tensor``'s split: column-parallel
    weights by output columns, the last dim; row-parallel ones by input
    rows, the one before it, which is dim 1 of ``wo``/``w2 [L, in, d]``
    and dim 2 of an MoE ``w_down [L, E, f, d]``), or ``None`` for a
    weight every rank holds whole. ``w_up [L, E, d, f]`` is a column
    weight: each tp rank holds ``d_ff/tp`` of every expert's units."""
    from .gpt_decode import _TP_COL, _TP_ROW  # that module imports this

    if tp == 1:
        return None
    if name in _TP_COL or name == "w_up":
        return ndim - 1
    return ndim - 2 if name in _TP_ROW or name == "w_down" else None


def _tp_slices(full: Params, mesh) -> Params:
    """Under tp this rank's column slice of ``wq/wk/wv/w1/w_up`` and row
    slice of ``wo/w2/w_down`` (views, :func:`_tp_dim`), every other
    weight whole."""
    tp = mesh.shape.get("tp", 1) if mesh is not None else 1
    if tp == 1:
        return dict(full)
    r = mesh.coords()["tp"]
    out = {}
    for name, t in full.items():
        dim = _tp_dim(name, t.dim(), tp)
        out[name] = t if dim is None else t.chunk(tp, dim=dim)[r]
    return out


def compute_params(full: Params, mesh, cfg: Optional[GPTConfig] = None
                   ) -> Params:
    """This rank's compute layout of the full weights on ``mesh``: under
    tp its column slice of ``wq/wk/wv/w1/w_up`` and row slice of
    ``wo/w2/w_down`` (views), every other weight whole. With ``cfg``: in
    a pipeline the block weights are its stage's layers (and tp slices),
    cut by :func:`_pp_tp_param_specs`, the rest whole; for an MoE model
    over ``cfg.ep_axis`` ``w_up``/``w_down`` hold its ``E/ep`` experts
    (of those, its tp slice)."""
    if cfg is not None and _pipelined(cfg, mesh):
        from ..parallel.sharding import Placement

        tp_ax = "tp" if mesh.shape.get("tp", 1) > 1 else None
        specs = _pp_tp_param_specs(block_names(full), cfg.pp_axis, tp_ax)
        return {n: Placement(mesh, specs[n]).shard(t) if n in specs else t
                for n, t in full.items()}
    out = _tp_slices(full, mesh)
    ep = _ep_axis(cfg, mesh) if cfg is not None and mesh is not None \
        else None
    if ep is not None:
        n, r = mesh.shape[ep], mesh.coords()[ep]
        for name in ("w_up", "w_down"):
            out[name] = out[name].chunk(n, dim=1)[r]
    return out


def make_train_step(cfg: GPTConfig, mesh=None, optimizer: Optional[
        Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
        *, rules=None, donate: bool = True, device: DeviceLike = None):
    """``(init, step, state_placements, batch_placement)`` for training
    on ``mesh`` (``gpt.py:499``); no mesh, or a one-rank mesh, trains on
    one card (``device``, default the card).

    - ``init(seed=0, params=None)`` → ``{"params", "opt", "step"}``:
      f32 master parameters (seeded :func:`init_params`, or a copy of
      ``params``, e.g. :func:`params_from_numpy`'s; every rank draws or
      passes the same full weights and keeps its shard) and the optimizer
      ``optimizer(params)`` builds over them (default
      ``torch.optim.AdamW`` with :data:`ADAMW_DEFAULTS`).
    - ``step(state, batch)`` → ``(state, {"loss", "perplexity"})`` (and
      ``"moe_aux"`` for an MoE model): one forward/backward/update on
      the GLOBAL batch, of which each rank takes its share; parameters
      and optimizer state are updated in place (``donate`` is accepted
      for the reference's signature: nothing is copied either way). The
      metrics are the global batch's.
    - ``state_placements`` is ``{"params", "opt", "step"}`` of
      :class:`~ray_tpu_torch.parallel.sharding.Placement`s: each
      parameter's placement under ``rules`` (default ``PP_LM_RULES`` when
      the mesh has ``cfg.pp_axis``, else ``LM_RULES``), the optimizer's
      moments following their parameter's; ``step`` replicated.
      ``batch_placement`` shards the batch rows over dp x fsdp.

    On several ranks every rank of ``mesh`` builds the step and calls
    ``init`` and ``step`` with the same arguments (one process per rank;
    see the module notes). Each step gathers every parameter from its
    shards except along the axes a rank computes its own piece of: a
    pipeline stage keeps its layers (the rules must split the block
    weights' layer dim over ``cfg.pp_axis``), an expert rank its experts
    (the expert dim over ``cfg.ep_axis``). Gradients of what every tp or
    ep rank computes in full are divided by that axis's size, the slices
    and pieces are reduced to their shards, and everything is averaged
    over the data ranks. MoE in a pipeline raises (see :func:`_check`)."""
    from ..parallel import mesh as pmesh
    from ..parallel import sharding as shr

    if mesh is None:
        mesh = pmesh.single_device_mesh(device=resolve_device(device))
    dev = mesh.device
    set_matmul_precision(dev)
    make_opt = optimizer or _default_optimizer
    _check(cfg, mesh)
    pp_axis = cfg.pp_axis if _pipelined(cfg, mesh) else None
    if rules is None:
        rules = shr.PP_LM_RULES if pp_axis else shr.LM_RULES
    shapes = param_shapes(cfg)
    placed = shr.tree_shardings(params_tree({
        n: torch.empty(s, device="meta") for n, s in shapes.items()}),
        mesh, rules)
    placements = params_flat(placed)
    state_placements = {"params": placements, "opt": placements,
                        "step": shr.Placement(mesh, shr.P())}
    batch_placement = shr.batch_sharding(mesh)

    def init(seed: int = 0, params: Optional[Params] = None) -> Dict:
        if params is None:
            params = init_params(cfg, seed, dev)
        local = {k: placements[k].shard(t.detach().to(
            device=dev, dtype=cfg.param_dtype)).requires_grad_(True)
            for k, t in params.items()}
        return {"params": local, "opt": make_opt(list(local.values())),
                "step": 0}

    if mesh.size == 1:
        def step(state: Dict, batch: Mapping) -> Tuple[Dict, Dict]:
            opt = state["opt"]
            opt.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(state["params"], batch, cfg, mesh)
            loss.backward()
            opt.step()
            return ({"params": state["params"], "opt": opt,
                     "step": state["step"] + 1}, metrics)

        return init, step, state_placements, batch_placement

    # The axes along which a rank computes with its own piece of a leaf:
    # the stage's layers (dim 0), the expert rank's experts (dim 1).
    ep_axis = _ep_axis(cfg, mesh)
    keep = {}
    if pp_axis:
        keep.update({n: (pp_axis, 0) for n in block_names(shapes)})
    if ep_axis:
        keep.update({n: (ep_axis, 1) for n in ("w_up", "w_down")})
    for n, (axis, dim) in keep.items():
        spec = placements[n].spec
        if len(spec) <= dim or spec[dim] != axis:
            raise ValueError(f"{n}: on {mesh.shape} the rules must split "
                             f"dim {dim} over {axis!r} alone, not {spec}")
    skip = {n: (axis,) for n, (axis, _) in keep.items()}
    computing = {n: placements[n].without(skip.get(n, ())) for n in shapes}
    tp = mesh.shape.get("tp", 1)
    tp_rank = mesh.coords().get("tp", 0)
    ep = mesh.shape[ep_axis] if ep_axis else 1
    rows = tuple(a for a in shr.BATCH_SPEC if a in mesh.shape)
    n_avg = mesh.size_of(_data_axes(mesh, cfg))

    def step(state: Dict, batch: Mapping) -> Tuple[Dict, Dict]:
        opt, local = state["opt"], state["params"]
        opt.zero_grad(set_to_none=True)
        names = sorted(local)            # one collective order on every rank
        with torch.no_grad():
            full = {n: computing[n].gather(local[n]) for n in names}
        comp = {n: t.detach().requires_grad_(True)
                for n, t in _tp_slices(full, mesh).items()}
        mine = {k: torch.as_tensor(v, device=dev).chunk(
            mesh.size_of(rows))[mesh.index(rows)] for k, v in batch.items()}
        loss, metrics = loss_fn(comp, mine, cfg, mesh)
        loss.backward()
        with torch.no_grad():
            for n in names:
                g = comp[n].grad
                if g is None:              # a stage that does not use it
                    g = torch.zeros_like(comp[n])
                dim = _tp_dim(n, g.dim(), tp)
                if dim is not None:        # this rank's slice, zero elsewhere
                    whole = torch.zeros_like(full[n])
                    whole.chunk(tp, dim=dim)[tp_rank].copy_(g)
                    g = whole
                elif tp > 1:               # every tp rank holds all of it
                    g = g / tp
                if ep > 1 and n not in skip:   # every ep rank's rows alike
                    g = g / ep
                local[n].grad = computing[n].reduce(
                    g, skip=skip.get(n, ())) / n_avg
            del full, comp
        opt.step()
        return ({"params": local, "opt": opt, "step": state["step"] + 1},
                metrics)

    return init, step, state_placements, batch_placement


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
