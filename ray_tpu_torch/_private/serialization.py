"""Serialization: pickle-5 framing with out-of-band zero-copy buffers.

The port's copy of ``ray_tpu/_private/serialization.py``: a small header
frame (metadata) followed by a pickle stream whose large buffers are
carried out of band, so they can be written straight into shared memory
or sent as scatter/gather iovecs without copies. Functions, lambdas and
local classes pickle by value through the port's vendored
:mod:`ray_tpu_torch.cloudpickle`.

numpy arrays keep the reference's contract exactly: their bodies travel
out of band and ``get`` returns a **read-only zero-copy view** of the
stored object.

``torch.Tensor`` (and ``nn.Parameter``) has a reducer of its own, in
place of ``torch``'s ``torch.save`` byte copy:

- a tensor is detached, brought to the host if it lies on a card (the
  counterpart of the reference's ``jax.Array`` → numpy: a CUDA tensor is
  restored as a CPU tensor, and the consumer moves it to its device), and
  made contiguous;
- its body travels out of band as raw bits, viewed as the integer type
  of the same width (bf16 and the other dtypes numpy lacks cross this
  way, bit for bit), with its dtype, shape and ``requires_grad`` in the
  pickle stream;
- **write protection by copy**: the tensor a ``get`` returns owns its
  memory, one host copy out of the stored object. PyTorch has no
  read-only tensors, and a zero-copy tensor over the segment would let
  one reader's in-place write reach every other reader's value (an
  inference-mode tensor refuses in-place writes only outside inference
  mode). A consumer that wants the card calls
  :func:`ray_tpu_torch.utils.device.device_put_shm`.

``torch`` is imported only when a value holds a tensor: the reducer looks
the tensor type up in ``sys.modules`` (a process that never imported
torch holds no tensor), and the rebuild imports torch in the process that
loads one.
"""
from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, Callable, Dict, List, Tuple

from .. import cloudpickle

_MAGIC = b"RTS1"


class SerializationContext:
    """Per-process serializer with a custom-type registry."""

    def __init__(self):
        self._custom: Dict[type, Tuple[Callable, Callable]] = {}

    def register_serializer(self, typ: type, *, serializer, deserializer):
        self._custom[typ] = (serializer, deserializer)

    def _reduce_custom(self, obj):
        for typ, (ser, de) in self._custom.items():
            if isinstance(obj, typ):
                return de, (ser(obj),)
        return NotImplemented

    def serialize(self, obj: Any) -> List[bytes]:
        """Returns a list of frames: [header, pickle_bytes, buf0, buf1, ...]."""
        buffers: List[pickle.PickleBuffer] = []

        class _Pickler(cloudpickle.CloudPickler):
            def reducer_override(this, o):  # noqa: N805
                r = self._reduce_custom(o)
                if r is not NotImplemented:
                    return r
                r = _reduce_tensor(o)
                if r is not NotImplemented:
                    return r
                return super().reducer_override(o)

        import io

        f = io.BytesIO()
        p = _Pickler(f, protocol=5, buffer_callback=buffers.append)
        p.dump(obj)
        body = f.getvalue()
        raws = [b.raw() for b in buffers]
        header = _MAGIC + struct.pack("<I", len(raws))
        return [header, body] + raws

    def deserialize(self, frames: List[bytes]) -> Any:
        header = bytes(frames[0])
        if header[:4] != _MAGIC:
            raise ValueError("bad serialization magic")
        (nbuf,) = struct.unpack("<I", header[4:8])
        body = frames[1]
        bufs = frames[2 : 2 + nbuf]
        return pickle.loads(body, buffers=bufs)


#: Integer dtype names by element width: a tensor's body is viewed as
#: one of these before it goes out of band.
_BITS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _reduce_tensor(obj):
    """Reduce a ``torch.Tensor`` or ``nn.Parameter`` (exact types) to
    :func:`_rebuild_tensor` over an out-of-band buffer of its bits, or
    NotImplemented for anything else. Never imports torch."""
    torch = sys.modules.get("torch")
    if torch is None:
        return NotImplemented
    kind = type(obj)
    if kind is not torch.Tensor and kind is not torch.nn.Parameter:
        return NotImplemented
    t = obj.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.resolve_conj().resolve_neg().contiguous()
    flat = t.reshape(-1)
    width = t.element_size()
    bits = flat.view(getattr(torch, _BITS.get(width, "uint8")))
    body = pickle.PickleBuffer(bits.numpy())
    return _rebuild_tensor, (str(t.dtype).split(".")[-1], tuple(t.shape),
                             body, bool(obj.requires_grad and obj.is_leaf),
                             kind is torch.nn.Parameter)


def _rebuild_tensor(dtype: str, shape: tuple, body, requires_grad: bool,
                    parameter: bool):
    """A CPU tensor that owns its memory: one copy of ``body``'s bits."""
    import numpy as np
    import torch

    out = torch.empty(shape, dtype=getattr(torch, dtype))
    if out.numel():
        out.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
            body, np.uint8)
    if parameter:
        return torch.nn.Parameter(out, requires_grad=requires_grad)
    return out.requires_grad_(requires_grad)


_ctx = SerializationContext()


def get_context() -> SerializationContext:
    return _ctx


def _native():
    from ray_tpu_torch import _native as native_pkg

    return native_pkg.load()


def pack_frames(frames: List[bytes]) -> bytes:
    """Concatenate frames with a length-prefixed index for single-blob
    storage. Hot path: the native codec does it in one pass/one copy."""
    nat = _native()
    if nat is not None:
        return nat.pack_frames(list(frames))
    head = struct.pack("<I", len(frames)) + b"".join(
        struct.pack("<Q", len(f)) for f in frames
    )
    return head + b"".join(bytes(f) for f in frames)


def pack_frames_into(dst, offset: int, frames: List[bytes]) -> int:
    """Scatter frames straight into a writable buffer (shm segment),
    skipping the intermediate blob. Returns bytes written."""
    nat = _native()
    if nat is not None:
        return nat.write_into(dst, offset, list(frames))
    blob = pack_frames(frames)
    # Publish-after-write (matches the native codec): body first, the
    # 4-byte frame count last, so a reader attached to a shared segment
    # mid-write sees count=0 (not ready) instead of a torn structure.
    # Pure Python cannot issue a release fence, so this ordering is only
    # guaranteed on TSO hardware (x86); the native codec carries the
    # proper release/acquire pair for weakly-ordered CPUs.
    mv = memoryview(blob)
    dst[offset + 4:offset + len(blob)] = mv[4:]
    dst[offset:offset + 4] = mv[:4]
    return len(blob)


def packed_size(frames: List[bytes]) -> int:
    return 4 + 8 * len(frames) + sum(len(f) for f in frames)


def unpack_frames(blob) -> List[memoryview]:
    mv = memoryview(blob)
    nat = _native()
    if nat is not None:
        return [mv[off:off + size]
                for off, size in nat.frame_offsets(mv)]
    # Same error contract as the native frame_offsets: ValueError on a
    # short header/table or a frame overrunning the blob (never
    # struct.error, never silently truncated frames).
    if len(mv) < 4:
        raise ValueError("blob too short for header")
    (n,) = struct.unpack("<I", mv[:4])
    if len(mv) < 4 + 8 * n:
        raise ValueError("blob too short for size table")
    sizes = struct.unpack(f"<{n}Q", mv[4 : 4 + 8 * n])
    out = []
    off = 4 + 8 * n
    for s in sizes:
        if off + s > len(mv):
            raise ValueError("frame overruns blob")
        out.append(mv[off : off + s])
        off += s
    return out
