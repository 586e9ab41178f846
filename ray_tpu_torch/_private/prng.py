"""Threefry2x32 PRNG, bit-exact with ``jax.random``'s default
implementation, so a seeded request samples the same tokens as the
reference.

The reference draws with four operations: ``PRNGKey``, ``split``,
``uniform`` and ``categorical`` (``gpt_decode.py:443``, ``:737``,
``:1549``). They are reimplemented here from JAX's own definitions
(``jax/_src/prng.py``: ``threefry_seed``, ``iota_2x32_shape``,
``threefry_2x32``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_gumbel``, ``categorical``), under the settings the
reference runs with: ``jax_threefry_partitionable=True`` (fold-like
split, 32-bit draws ``bits1 ^ bits2`` over a 64-bit counter) and 64-bit
mode off (a seed keeps its low 32 bits).

Keys are int64 tensors ``[..., 2]`` holding the two uint32 words. Every
function treats the leading dims as independent lanes, as the
reference's ``jax.vmap`` over per-slot keys does: ``split`` of ``[B, 2]``
keys gives ``[B, num, 2]``, a draw of ``shape`` from ``[B, 2]`` keys gives
``[B, *shape]``. The words are uint32 on the host (``np.uint32 [slots,
2]``, as in the reference) and int64 on a device, because torch
implements neither add nor shifts for ``torch.uint32`` on the CPU: every
add and rotate is masked back to 32 bits. Draws run on the keys'
device and never synchronise with the host.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Smallest normal float32: the lower bound of the Gumbel uniform.
_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int) -> np.ndarray:
    """The key ``jax.random.PRNGKey(seed)`` makes with 64-bit mode off:
    ``[0, seed mod 2**32]`` as ``np.uint32 [2]``. Like the reference,
    seeds outside int64 raise."""
    seed = int(np.int64(seed))          # OverflowError outside int64
    return np.array([0, seed & _MASK], np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds (``prng.py:883``):
    key words ``k1, k2`` and counter words ``x1, x2`` broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash(key: torch.Tensor, shape: Sequence[int]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry of each lane's key over a row-major 64-bit counter of
    ``shape`` (``iota_2x32_shape``): ``[*lanes, *shape]`` word pairs."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (count >> 32).reshape(shape), (count & _MASK).reshape(shape)
    lanes = key.shape[:-1]
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(lanes + pad)
    k2 = key[..., 1].reshape(lanes + pad)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like): ``[..., 2]`` keys →
    ``[..., num, 2]``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit draws ``[..., *shape]`` (int64 holding uint32), as
    ``jax.random.bits``."""
    b1, b2 = _hash(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Float32 draws in ``[minval, maxval)`` (``random.py:435``): the 23
    high bits fill the mantissa of a float in [1, 2), minus 1, scaled,
    floored at ``minval``."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # The bounds as float32 values, formed on the host: a scalar tensor
    # made on the card per call would be a blocking copy.
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Float32 Gumbel noise, the reference's ``mode="low"``
    (``random.py:1723``): ``-log(-log(uniform(tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (``random.py:1739``):
    ``argmax(gumbel + logits)``, first index on ties. Keys ``[*lanes,
    2]`` each draw over their slice of ``logits [*lanes, *rest]``, so a
    single key over ``[B, V]`` logits draws one ``[B, V]`` noise block
    and ``[B, 2]`` keys draw one ``[V]`` block per row. Float32 logits
    only: the reference draws its noise in the logits' dtype, and only
    the float32 draw is ported. Returns int64 ``[*lanes,
    *rest[:-1]]``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
