"""Threefry2x32 PRNG, bit-exact with ``jax.random``'s default
implementation, so a seeded request samples the same tokens as the
reference.

The reference draws with five operations: ``PRNGKey``, ``split``,
``uniform`` and ``categorical`` (``gpt_decode.py:443``, ``:737``,
``:1549``), and ``normal`` for its weights (``gpt.py:86``). They are
reimplemented here from JAX's own definitions (``jax/_src/prng.py``:
``threefry_seed``, ``iota_2x32_shape``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_gumbel``, ``categorical``,
``_normal_real``), under the settings the
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


# ``normal`` is ``sqrt(2) * erf_inv(u)``, and ``lax.erf_inv`` is neither
# ``torch.erfinv`` nor Giles' polynomial over ``torch.log1p``: XLA's CPU
# backend lowers it to its own f32 sequence, with its own ``log1p``. The
# functions below are that sequence, operation for operation, taken from
# what XLA emits for ``jax.jit(lax.erf_inv)`` on f32 (jax 0.9.0, x86-64,
# ``XLA_FLAGS=--xla_dump_to=DIR``): the order of operations and the
# constants from ``*.jit_erf_inv.*.ir-with-opt.ll`` (``@xla.log1p.f32``
# is inlined there; its hex floats are written here as float32 bit
# patterns), and the fused multiply-adds from the object file beside it
# (``objdump -d``: ``vfmadd*ps``). XLA's CPU compiler lets LLVM contract
# a multiply into the add that is its only use, so every Horner step is
# one FMA: :func:`_fma` rounds those once, and every other step is one
# separately rounded f32 torch op, on the CPU and on the card alike.


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` for float32 values, rounded once to float32, as an
    FMA instruction rounds it. The product is exact in float64; the sum
    is rounded there to odd (round to nearest, then an inexact result
    with an even last bit steps one ulp toward the exact value, whose
    error TwoSum gives exactly), and rounding a round-to-odd float64 to
    float32 is correct rounding (53 >= 2 * 24 + 2 bits)."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)

    p = d(a) * d(b)
    cd = d(c)
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. ``torch.sqrt`` on the CPU
    (vectorised through MKL) is not: it rounds 0.7 % of float32 inputs
    the other way, where XLA's ``vsqrtps`` is exact. The float64 root is
    within one float32 ulp of the answer; the midpoints on either side,
    squared exactly in float64, say which neighbour is right."""
    c = torch.sqrt(x.double()).float()
    xd = x.double()
    up = torch.nextafter(c, torch.full_like(c, float("inf")))
    dn = torch.nextafter(c, torch.full_like(c, float("-inf")))
    hi = (c.double() + up.double()) * 0.5
    lo = (c.double() + dn.double()) * 0.5
    return torch.where(hi * hi < xd, up, torch.where(lo * lo > xd, dn, c))


def _f32(bits: int) -> float:
    """The float32 with these bits, as an exact Python float."""
    return float(np.uint32(bits).view(np.float32))


#: log1p's small-argument branch: a ratio of two degree-6 polynomials in
#: x (numerator from a zero leading term, as the IR has it).
_LOG1P_NUM = (0x00000000, 0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D,
              0x439A8CA3, 0x43586D8A, 0x42707982)
_LOG1P_DEN = (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
              0x426473AD, 0x41A05101)
#: |x| below this (0.41421357, sqrt 2 - 1) takes the small branch.
_LOG1P_SMALL = 0x3ED413CD
#: The log branch (Cephes' logf): mantissa split at sqrt(1/2), three
#: pairs of coefficients, and ln 2 in two parts.
_LOG_SQRTHF = 0x3F3504F3
_LOG_P = ((0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A),
          (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50),
          (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LN2_LO = 0xB95E8083
_LN2_HI = 0x3F318000
#: erf_inv's Giles coefficients, (w < 5, w >= 5) pairs, highest first.
_ERFINV_C = ((0x32F16588, 0xB951F09B), (0x34B84B36, 0x38D3B56B),
             (0xB66C7357, 0x3AB0DC72), (0xB6935AC1, 0xBB70BDE7),
             (0x396532DB, 0x3BBC127B), (0xBAA45408, 0xBBF9C5D7),
             (0xBB88E4EF, 0x3C1AA57E), (0x3E7C8F63, 0x3F8036DB),
             (0x3FC02E2F, 0x40354F7E))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log1p`` for float32 (``@xla.log1p.f32``)."""
    # Small |x|: x - x^2/2 + x^3 * num(x) / den(x); x^2 has two uses, so
    # its multiply stays unfused (the -0.5 scaling is exact either way).
    x2 = x * x
    zero = x * 0.0
    num = zero + _f32(_LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        num = _fma(num, x, _f32(c))
    den = zero + _f32(_LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, _f32(c))
    small = x + _fma(x2, -0.5, (x * x2) * (den / num))
    # Otherwise log(1 + x): exponent and mantissa in [0.5, 1) from the
    # bits of max(1 + x, FLT_MIN), the mantissa folded at sqrt(1/2).
    y = x + 1.0
    m = torch.where(y > _TINY, y, _TINY)
    bits = m.view(torch.int32)
    f = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    lo = f < _f32(_LOG_SQRTHF)
    e = e - torch.where(lo, 1.0, 0.0)
    r = (f + -1.0) + torch.where(lo, f, 0.0)
    z = r * r
    r3 = z * r
    (a1, a2, a3), (b1, b2, b3), (c1, c2, c3) = _LOG_P
    pa = _fma(_fma(r, _f32(a1), _f32(a2)), r, _f32(a3))
    pb = _fma(_fma(r, _f32(b1), _f32(b2)), r, _f32(b3))
    pc = _fma(_fma(r, _f32(c1), _f32(c2)), r, _f32(c3))
    t = _fma(_fma(_fma(pa, r3, pb), r3, pc), r3, e * _f32(_LN2_LO))
    # z * 0.5 and e * ln2_hi (9 significant bits times a small integer)
    # are exact: fused or not, these two round once.
    big = ((r - z * 0.5) + t) + e * _f32(_LN2_HI)
    # The IR's special cases, by value: -inf at y == 0, +inf at y ==
    # inf, NaN for y < 0 or NaN.
    big = torch.where((y <= 0) | torch.isnan(y), float("nan"), big)
    big = torch.where(y == float("inf"), float("inf"), big)
    big = torch.where(y == 0, float("-inf"), big)
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` for float32 as XLA's CPU backend computes it:
    Giles' single-precision approximation over :func:`_log1p`, with
    ``erf_inv(+-1) = +-inf``."""
    lg = _log1p(x * -x)                  # -w
    lt = lg > -5.0                       # w < 5
    w = torch.where(lt, -2.5 - lg, _sqrt(-lg) + -3.0)

    def coeff(i):
        a, b = _ERFINV_C[i]
        return torch.where(lt, _f32(a), _f32(b))

    p = _fma(coeff(0), w, coeff(1))
    for i in range(2, len(_ERFINV_C)):
        p = _fma(w, p, coeff(i))
    return x * torch.where(x.abs() == 1.0, float("inf"), p)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Float32 standard normals ``[..., *shape]``, bit-equal to
    ``jax.random.normal`` (``random.py:_normal_real``): ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, 1.0))


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
