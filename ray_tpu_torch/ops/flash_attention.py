"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, and the differentiable public function.

Port of ``ray_tpu/ops/flash_attention.py``. :func:`flash_attention` keeps
the reference's signature and layout: q, k, v ``[B, S, H, hd]`` in,
``[B, S, H, hd]`` out, differentiable through a ``torch.autograd.Function``
that saves ``(qs, k, v, o, lse)`` as the reference's ``custom_vjp`` does.
Rounding points follow the reference exactly: q is scaled in the compute
dtype before the kernel (``q * dtype(sm_scale)``), logits and softmax
statistics are f32, p is cast to v's dtype before ``p . v``, ``lse`` is f32
``[B, H, S, 1]``; the backward recomputes p from ``lse`` and rounds
``p * (dp - delta)`` to the compute dtype before its two products.

- :func:`flash_fwd_plain` / :func:`flash_bwd_plain` are the plain
  versions (one full-width softmax; the backward's formulas written out,
  not autograd through a softmax). The CPU tests hold them against the
  JAX package; ``chip_smoke.py`` holds the kernels against them.
- :func:`flash_fwd` / :func:`flash_bwd` are the kernels' wrappers
  (``csrc/flash_attention.cu``): K2 forward, K3a (dK, dV) and K3b (dQ)
  backward. On CUDA tensors they launch or raise; on CPU tensors they run
  the plain versions. :data:`launches` counts each kernel's launches.

The kernels read the ``[B, S, H, hd]`` layout as it is (no transposes);
``lse`` and ``delta`` are ``[B, H, S]`` f32. They take head_dim 32, 64 or
128 (nano, small/medium, 1b) in float32 or bfloat16; the wrappers raise on
anything else. Built at first use by :mod:`ray_tpu_torch.ops._build`.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by the wrappers in this process, by kernel.
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq": 0}

_lock = threading.Lock()
_lib = None


# ------------------------------------------------------------ plain versions
def _acc(dtype: torch.dtype) -> torch.dtype:
    """f32, the reference's accumulation type; f64 stays f64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _logits(qs, k, causal: bool) -> torch.Tensor:
    """s = qs . k^T ``[B, H, S, Sk]`` in the accumulation type, columns
    past the causal diagonal (col > row) at NEG_INF."""
    acc = _acc(qs.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(acc), k.to(acc))
    if causal:
        S, Sk = s.shape[-2:]
        mask = torch.ones(S, Sk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(mask, NEG_INF)
    return s


def flash_fwd_plain(qs, k, v, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, S, H, hd]``, lse ``[B, H, S, 1]``) for pre-scaled ``qs``:
    one full-width softmax (the reference is blockwise; both give the same
    function)."""
    acc = _acc(qs.dtype)
    s = _logits(qs, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    o = (pv / l).to(qs.dtype).transpose(1, 2).contiguous()
    return o, m + torch.log(l)


def _delta(do, o) -> torch.Tensor:
    """rowsum(f32(dO) * f32(O)) as ``[B, H, S, 1]`` (``:230``)."""
    acc = _acc(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)[..., None]


def flash_bwd_plain(qs, k, v, o, lse, do, sm_scale: float, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients w.r.t. the ORIGINAL q, k, v: the reference backward's
    formulas (``_bwd_fused_kernel``) over the full sequence."""
    acc = _acc(qs.dtype)
    delta = _delta(do, o)
    p = torch.exp(_logits(qs, k, causal) - lse.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    ds = (p * (dp - delta)).to(qs.dtype).to(acc)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.to(acc))
    dqs = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    return ((dqs * sm_scale).to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype))


# ------------------------------------------------------------------ kernels
def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = _build.build("flash_attention")
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.rt_flash_fwd.argtypes = [vp] * 5 + [ci] * 8 + [vp]
            lib.rt_flash_bwd_dkdv.argtypes = [vp] * 8 + [ci] * 8 + [vp]
            lib.rt_flash_bwd_dq.argtypes = ([vp] * 7 + [ci] * 6
                                            + [ctypes.c_float, ci, ci, vp])
            for fn in (lib.rt_flash_fwd, lib.rt_flash_bwd_dkdv,
                       lib.rt_flash_bwd_dq):
                fn.restype = ci
            _lib = lib
        return _lib


def supported(q: torch.Tensor) -> bool:
    """Whether the kernels take q's dtype and head_dim."""
    return q.dtype in _DTYPE_CODE and q.dim() == 4 \
        and q.shape[-1] in HEAD_DIMS


def _check(qs, k, v, o=None, lse=None, do=None) -> None:
    """Validate what the kernels take (shapes, dtypes, layout)."""
    if not supported(qs):
        raise ValueError(
            f"flash kernels take float32/bfloat16 [B, S, H, hd] with hd in "
            f"{HEAD_DIMS}; got {qs.dtype} {tuple(qs.shape)}")
    B, S, H, hd = qs.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (H, hd) \
            or v.shape != k.shape or k.shape[1] < 1 or S < 1:
        raise ValueError(f"k, v must be [{B}, Sk, {H}, {hd}], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    tensors = [qs, k, v]
    for t in (o, do):
        if t is not None:
            if t.shape != qs.shape:
                raise ValueError(f"o/dO must be {tuple(qs.shape)}, got "
                                 f"{tuple(t.shape)}")
            tensors.append(t)
    for t in tensors:
        if t.dtype != qs.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} / {qs.dtype}")
    if lse is not None:
        if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S, 1):
            raise ValueError(f"lse must be float32 [{B}, {H}, {S}, 1]")
        tensors.append(lse)
    for t in tensors:
        if t.device != qs.device:
            raise ValueError(f"tensor on {t.device}, q on {qs.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels need contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned tensors")


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {t.device.type} "
                         f"tensors")
    return True


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_fwd(qs, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors (current stream, no synchronisation); the plain
    version on CPU tensors. Returns (o, lse ``[B, H, S, 1]`` f32)."""
    if not _route(qs):
        return flash_fwd_plain(qs, k, v, causal)
    _check(qs, k, v)
    lib = _load()
    B, S, H, hd = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty(B, H, S, 1, dtype=torch.float32, device=qs.device)
    _raise_on(lib.rt_flash_fwd(
        o.data_ptr(), lse.data_ptr(), qs.data_ptr(), k.data_ptr(),
        v.data_ptr(), B, H, S, k.shape[1], hd, int(causal),
        _DTYPE_CODE[qs.dtype], qs.device.index or 0,
        torch.cuda.current_stream(qs.device).cuda_stream), "flash forward")
    launches["flash_attention_fwd"] += 1
    return o, lse


def flash_bwd(qs, k, v, o, lse, do, sm_scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3a (dK, dV) and K3b (dQ) on CUDA tensors; the plain version on CPU
    tensors. ``delta`` is a plain torch op here, outside the kernels, as
    in the reference."""
    if not _route(qs):
        return flash_bwd_plain(qs, k, v, o, lse, do, sm_scale, causal)
    _check(qs, k, v, o, lse, do)
    delta = _delta(do, o).contiguous()
    dk, dv = _launch_dkdv(qs, k, v, do, lse, delta, causal)
    return _launch_dq(qs, k, v, do, lse, delta, sm_scale, causal), dk, dv


def _launch_dkdv(qs, k, v, do, lse, delta, causal: bool):
    """K3a on checked CUDA tensors → (dk, dv)."""
    B, S, H, hd = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _raise_on(_load().rt_flash_bwd_dkdv(
        dk.data_ptr(), dv.data_ptr(), qs.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B, H, S, k.shape[1], hd, int(causal), _DTYPE_CODE[qs.dtype],
        qs.device.index or 0,
        torch.cuda.current_stream(qs.device).cuda_stream), "flash dK/dV")
    launches["flash_attention_bwd_dkdv"] += 1
    return dk, dv


def _launch_dq(qs, k, v, do, lse, delta, sm_scale: float, causal: bool):
    """K3b on checked CUDA tensors → dq = dtype(dQ * sm_scale)."""
    B, S, H, hd = qs.shape
    dq = torch.empty_like(qs)
    _raise_on(_load().rt_flash_bwd_dq(
        dq.data_ptr(), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, H, S,
        k.shape[1], hd, int(causal), sm_scale, _DTYPE_CODE[qs.dtype],
        qs.device.index or 0,
        torch.cuda.current_stream(qs.device).cuda_stream), "flash dQ")
    launches["flash_attention_bwd_dq"] += 1
    return dq


# --------------------------------------------------------------- public API
def scale_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """``q * dtype(sm_scale)`` in q's dtype (``:266``); 1.0 leaves q as is."""
    if sm_scale == 1.0:
        return q
    return q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, causal: bool):
        qs = scale_q(q, sm_scale)
        o, lse = flash_fwd(qs, k, v, causal)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(qs, k, v, o, lse, do.contiguous(),
                               ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention. q, k, v: ``[B, S, H, hd]`` → ``[B, S, H, hd]``
    (k, v may have another length when not causal). Differentiable; the
    kernels on CUDA tensors, the plain versions on CPU tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal))
