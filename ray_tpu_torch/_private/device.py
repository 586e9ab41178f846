"""Device resolution and the matmul precision the port relies on.

Every entry point (``DecodeEngine``, ``init_params``, ``params_from_numpy``,
``init_paged_cache``, ``init_cache``, ``init_slot_cache``, ``generate``,
``generate_chunked``, ``ModelDrafter``, ``make_train_step``) takes
``device=None`` and resolves it here: no
argument means the card, and a missing card is an error. The port never
carries on quietly on the CPU; tests ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is visible); anything else
    is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_matmul_precision(device: Optional[torch.device]) -> None:
    """Pin the GEMM precision the reference's ``_mm`` has
    (``ray_tpu/models/gpt.py:145``: operands in the compute dtype, f32
    accumulation, ONE cast of the result):

    - ``allow_tf32 = False``: an f32 product stays full f32 (TF32 keeps
      about three decimal digits and would flip greedy ties against the
      f32 reference);
    - ``allow_bf16_reduced_precision_reduction = False``: a bf16 GEMM
      keeps its split-K partial sums in f32 and rounds to bf16 once,
      instead of rounding each partial.

    Process-wide flags; set for CUDA devices only (the CPU ignores them)."""
    if device is not None and device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Full f32 products and convolutions inside the block: TF32 off for
    cuBLAS and for cuDNN (whose default is on), the flags restored on the
    way out, so a caller's process-wide choice is left as it was. The
    CPU ignores both flags."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
