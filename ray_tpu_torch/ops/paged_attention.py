"""Paged decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``ray_tpu/models/gpt_decode.py::_paged_attention_pallas`` (the
TPU kernel) and ``_paged_attention_gather`` (its XLA reference). One
decode step: each slot's query ``q [B, 1, H, hd]`` attends over the
pages its page-table row ``pt [B, max_pages]`` maps, valid at positions
``<= pos[b]``; the result is ``[B, 1, H, hd]`` in ``q``'s dtype. int8
pools pass per-(page, head) f32 scales ``ks``/``vs [n_pages, H]``.

- :func:`paged_attention_gather` is the plain version: gather every
  mapped page into virtual order, masked full-length softmax. The CPU
  tests hold it against the JAX package; ``chip_smoke.py`` holds the
  kernel against it on the card.
- :func:`paged_attention_cuda` is the kernel's wrapper
  (``csrc/paged_attention.cu``). On a CUDA tensor it launches the kernel
  or raises; it takes the plain version only for tensors on the CPU.
  :data:`launches` counts its launches. The kernel splits each (slot,
  head) over a cluster of up to 8 blocks by page-table columns;
  :func:`_launch_plan` sizes the cluster, each rank's columns, the ring
  of TMA page slots and the shared memory from shapes alone.

The kernel is built from the source in this package at first use, by
``nvcc`` into a shared library with a plain C interface
(:mod:`ray_tpu_torch.ops._build`), and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import _build

#: Kernel launches made by :func:`paged_attention_cuda` in this process.
launches = 0

MAX_HEAD_DIM = 128
MAX_CLUSTER = 8                  # blocks per (slot, head): portable size
MAX_PAGE_SIZE = 256              # positions per TMA box
_WARPS = 4                       # 128 threads a block
_SMEM_LIMIT = 232448             # an H100 block's shared memory (227 KB)
# The ring of page slots a block keeps in flight. Each block's life is
# short and the card holds as many blocks as their shared memory allows,
# so a small ring that is refilled beats a large one (measured on the
# H100: 16 KB against 8, 32, 64 and 96 KB; PERF.md).
RING_BYTES = 16 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
_plans_ready = set()     # (dtype, quant, plan, device) readied on the card


class LaunchPlan(NamedTuple):
    """How one call is launched: ``cluster`` blocks per (slot, head), at
    most ``cols_per_rank`` page-table columns per block, a ring of
    ``stages`` page slots, ``smem`` bytes of shared memory a block."""
    cluster: int
    cols_per_rank: int
    stages: int
    smem: int


def _smem_bytes(cluster: int, cols_per_rank: int, stages: int,
                page_size: int, hd: int, elem: int) -> int:
    """A block's shared memory, as ``Layout`` in
    ``csrc/paged_attention.cu`` sizes it for the launch (here only to
    refuse a table the card cannot hold): the ring, then 4-byte words (the
    rank's logits, q, the warps' p·v rows, the ranks' partial rows, max
    and exp-sum, the live pages' scales, pages and count), then one
    8-byte mbarrier per slot."""
    ring = stages * page_size * hd * elem
    words = (cols_per_rank * page_size + (1 + _WARPS + cluster) * hd + 2
             + 3 * cols_per_rank + 1)
    return (ring + 4 * words + 7) // 8 * 8 + 8 * stages


@functools.lru_cache(maxsize=None)
def _launch_plan(max_pages: int, page_size: int, hd: int, elem: int
                 ) -> LaunchPlan:
    """The launch for a table of ``max_pages`` columns of ``page_size``
    positions over pools of ``elem``-byte elements at ``hd``: from shapes
    only (never ``pos``). Raises ValueError where the kernel cannot run."""
    if max_pages < 1 or page_size < 1:
        raise ValueError(f"empty page table ({max_pages} columns of "
                         f"{page_size})")
    if page_size > MAX_PAGE_SIZE:
        raise ValueError(f"page_size {page_size} > {MAX_PAGE_SIZE} (one TMA "
                         f"box per page)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    cluster = min(MAX_CLUSTER, max_pages)
    cpr = -(-max_pages // cluster)
    stages = max(1, min(2 * cpr, RING_BYTES // (page_size * hd * elem)))
    smem = _smem_bytes(cluster, cpr, stages, page_size, hd, elem)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{max_pages} columns of {page_size} positions need "
                         f"{smem} B of shared memory a block (limit "
                         f"{_SMEM_LIMIT})")
    return LaunchPlan(cluster, cpr, stages, smem)


def rank_columns(max_pages: int, cluster: int) -> List[range]:
    """The page-table columns each block of a cluster takes (the kernel's
    ``[r * max_pages / C, (r + 1) * max_pages / C)``)."""
    return [range(r * max_pages // cluster, (r + 1) * max_pages // cluster)
            for r in range(cluster)]


def deq_page(codes: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    """int8 page codes ``[..., page_size, H, hd]`` under their
    per-(page, head) scales ``[..., H]`` → the compute dtype
    (``gpt_decode.py:896``; the kernel dequantises the same way)."""
    return (codes.float() * scales[..., None, :, None]).to(dtype)


def softmax_scale(hd: int) -> float:
    """f32 ``1/sqrt(hd)``, the reference's value bit for bit."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def paged_attention_gather(q, kc, vc, pt, pos, page_size: int,
                           ks=None, vs=None) -> torch.Tensor:
    """Plain version: page-table gather + masked full-length softmax
    (``gpt_decode.py:1058``). Page-table entries are clamped into the
    pool, so a sentinel column reads some real page whose positions the
    ``<= pos`` mask hides; out-of-range reads never happen."""
    B, _, H, hd = q.shape
    n_pages = kc.shape[0]
    V = pt.shape[1] * page_size
    ptc = pt.long().clamp(0, n_pages - 1)
    hk, hv = kc[ptc], vc[ptc]
    if ks is not None:
        hk = deq_page(hk, ks[ptc], q.dtype)
        hv = deq_page(hv, vs[ptc], q.dtype)
    hk = hk.reshape(B, V, H, hd)
    hv = hv.reshape(B, V, H, hd)
    valid = (torch.arange(V, device=q.device)[None, :]
             <= pos.long()[:, None])[:, None, None, :]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          hk.float()) * softmax_scale(hd)
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        hv.float()).to(q.dtype)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = _build.build("paged_attention")
            lib = ctypes.CDLL(str(path))
            fn = lib.rt_paged_attention
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([vp] * 8 + [ci] * 8 + [ctypes.c_float] + [ci] * 3
                           + [vp])
            fn.restype = ci
            prep = lib.rt_paged_attention_prepare
            prep.argtypes = [ci] * 8
            prep.restype = ci
            _lib = lib
        return _lib


def _check(q, kc, vc, pt, pos, page_size, ks, vs) -> bool:
    """Validate what the kernel takes; returns whether the pool is int8."""
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    quant = kc.dtype == torch.int8
    if quant != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError("int8 pools need ks and vs; fp pools take neither")
    if not quant and kc.dtype != q.dtype:
        raise TypeError(f"fp pool dtype {kc.dtype} != q dtype {q.dtype}")
    if kc.dim() != 4 or kc.shape[1:] != (page_size, H, hd) \
            or vc.shape != kc.shape or vc.dtype != kc.dtype:
        raise ValueError(f"pools must be [n_pages, {page_size}, {H}, {hd}]"
                         f", got {tuple(kc.shape)} / {tuple(vc.shape)}")
    n_pages = kc.shape[0]
    if pt.dtype != torch.int32 or pt.dim() != 2 or pt.shape[0] != B:
        raise ValueError(f"pt must be int32 [{B}, max_pages]")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be int32 [{B}]")
    tensors = [q, kc, vc, pt, pos]
    if quant:
        for s in (ks, vs):
            if s.dtype != torch.float32 or tuple(s.shape) != (n_pages, H):
                raise ValueError(f"scales must be float32 [{n_pages}, {H}]")
        tensors += [ks, vs]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError("paged_attention_cuda needs contiguous inputs")
    # The kernel loads 16 bytes at a time: a head row must be a
    # power-of-two number of 16-byte vectors, and the pools aligned.
    vec = 16 // kc.element_size()
    lanes = hd // vec
    if hd % vec or lanes & (lanes - 1) or not 1 <= lanes <= 32:
        raise ValueError(f"head_dim {hd} must be a power-of-two multiple "
                         f"of {vec} for {kc.dtype} pools")
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")
    return quant


def _prepare(lib, dtype: int, quant: bool, hd: int, page_size: int,
             max_pages: int, plan: LaunchPlan, device: int) -> int:
    """Ready ``plan`` on ``device`` (the kernel's shared-memory limit) and
    return how many of its clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises if the card cannot run
    one."""
    n = lib.rt_paged_attention_prepare(dtype, int(quant), hd, page_size,
                                       max_pages, plan.cluster, plan.stages,
                                       device)
    if n <= 0:
        raise RuntimeError(f"paged attention: the card cannot hold a cluster"
                           f" of {plan} (occupancy query returned {n})")
    return n


def paged_attention_cuda(q, kc, vc, pt, pos, page_size: int,
                         ks: Optional[torch.Tensor] = None,
                         vs: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The kernel on CUDA tensors (launched on the current stream, no
    synchronisation); the plain version on CPU tensors. Anything else, or
    a failed launch, raises."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_gather(q, kc, vc, pt, pos, page_size, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda: no kernel for "
                         f"{q.device.type} tensors")
    quant = _check(q, kc, vc, pt, pos, page_size, ks, vs)
    B, _, H, hd = q.shape
    max_pages = pt.shape[1]
    plan = _launch_plan(max_pages, page_size, hd, kc.element_size())
    lib = _load()
    device = q.device.index or 0
    dtype = _DTYPE_CODE[q.dtype]
    key = (dtype, quant, plan, device)
    if key not in _plans_ready:       # once per plan, before its launches
        with _lock:
            _prepare(lib, dtype, quant, hd, page_size, max_pages, plan,
                     device)
            _plans_ready.add(key)
    out = torch.empty_like(q)
    rc = lib.rt_paged_attention(
        out.data_ptr(), q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        pt.data_ptr(), pos.data_ptr(), B, H, hd, kc.shape[0], page_size,
        max_pages, dtype, int(quant), softmax_scale(hd), plan.cluster,
        plan.stages, device, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
