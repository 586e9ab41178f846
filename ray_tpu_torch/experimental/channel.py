"""Mutable-object channels: single-writer, multi-reader shm slots.

The port's copy of ``ray_tpu/experimental/channel.py``.

Capability parity with the reference's compiled-graph channel substrate
(reference: ``python/ray/experimental/channel/shared_memory_channel.py``
— a mutable plasma object the writer overwrites in place and readers
acquire/release), re-designed for this runtime as a named POSIX shm
segment with a version/ack protocol:

    [u64 version][u32 num_readers][u32 closed][u64 acks[R]][u64 len][data]

- ``write`` waits until every reader acked the previous version, then
  serializes into the slot and bumps the version (1-deep backpressure,
  like the reference's default buffer).
- ``read(reader_idx)`` waits for an unseen version, deserializes, acks.

Channels are picklable by name; any process on the host attaches.
"""
from __future__ import annotations

import pickle
import struct
import time
from typing import Any

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import _open_shm

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


class ChannelClosed(Exception):
    pass


class Channel:
    """One single-writer slot; create in the driver, ship to actors."""

    def __init__(self, capacity_bytes: int = 1 << 20, num_readers: int = 1,
                 *, _name: str = None):
        self.capacity = capacity_bytes
        self.num_readers = num_readers
        if _name is not None:
            self.name = _name
            self._shm = _open_shm(self.name)
        else:
            # FULL hex: ids are counter-based and a truncated prefix can
            # collide within a burst (the counter sits mid-id).
            self.name = "rtchan_" + ObjectID.from_random().hex()
            size = self._data_off() + 8 + capacity_bytes
            self._shm = _open_shm(self.name, create=True, size=size)
            self._shm.buf[:self._data_off()] = b"\x00" * self._data_off()
            self._shm.buf[8:12] = _U32.pack(num_readers)

    def _data_off(self) -> int:
        return 16 + 8 * self.num_readers

    @classmethod
    def _attach(cls, capacity: int, num_readers: int, name: str):
        return cls(capacity, num_readers, _name=name)

    def __reduce__(self):
        return (Channel._attach,
                (self.capacity, self.num_readers, self.name))

    # ------------------------------------------------------------- header
    def _version(self) -> int:
        return _U64.unpack_from(self._shm.buf, 0)[0]

    def _ack(self, idx: int) -> int:
        return _U64.unpack_from(self._shm.buf, 16 + 8 * idx)[0]

    def _closed(self) -> bool:
        return _U32.unpack_from(self._shm.buf, 12)[0] != 0

    # -------------------------------------------------------------- write
    def write(self, value: Any, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        version = self._version()
        while any(self._ack(i) < version for i in range(self.num_readers)):
            if self._closed():
                raise ChannelClosed
            if time.time() > deadline:
                raise TimeoutError("channel readers lagging")
            time.sleep(0.0002)
        blob = pickle.dumps(value, protocol=5)
        if len(blob) > self.capacity:
            raise ValueError(
                f"value ({len(blob)}B) exceeds channel capacity "
                f"({self.capacity}B)")
        off = self._data_off()
        self._shm.buf[off:off + 8] = _U64.pack(len(blob))
        self._shm.buf[off + 8:off + 8 + len(blob)] = blob
        self._shm.buf[0:8] = _U64.pack(version + 1)

    # --------------------------------------------------------------- read
    def read(self, reader_idx: int = 0, timeout: float = 30.0) -> Any:
        deadline = time.time() + timeout
        seen = self._ack(reader_idx)
        while self._version() <= seen:
            if self._closed():
                raise ChannelClosed
            if time.time() > deadline:
                raise TimeoutError("channel writer idle")
            time.sleep(0.0002)
        version = self._version()
        off = self._data_off()
        (n,) = _U64.unpack_from(self._shm.buf, off)
        value = pickle.loads(bytes(self._shm.buf[off + 8:off + 8 + n]))
        self._shm.buf[16 + 8 * reader_idx:24 + 8 * reader_idx] = \
            _U64.pack(version)
        return value

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        try:
            self._shm.buf[12:16] = _U32.pack(1)
        except (ValueError, TypeError):
            pass

    def destroy(self) -> None:
        self.close()
        try:
            self._shm.close()
            self._shm.unlink()
        except Exception:
            pass


class TcpChannel:
    """Single-writer multi-reader channel ACROSS shm domains.

    Counterpart of the reference's cross-node mutable-object transfer
    (reference: ``node_manager.proto:430-432`` — the writer's raylet
    pushes each new value to every reader node): items are pushed over
    the worker RPC plane to each reader's process, acks flow back for
    the same 1-deep backpressure the shm channel enforces. The channel
    object is picklable; whichever process calls ``write``/``read``
    uses its own CoreWorker as the transport endpoint.
    """

    def __init__(self, reader_addresses, capacity_bytes: int = 0,
                 *, _name: str = None):
        self.name = _name or ("rtchan_" + ObjectID.from_random().hex())
        self.reader_addresses = [
            tuple(a) if isinstance(a, list) else a
            for a in reader_addresses]
        self.num_readers = len(self.reader_addresses)
        self.capacity = capacity_bytes  # unused; parity with Channel

    @classmethod
    def _attach(cls, reader_addresses, capacity, name):
        return cls(reader_addresses, capacity, _name=name)

    def __reduce__(self):
        return (TcpChannel._attach,
                (self.reader_addresses, self.capacity, self.name))

    def write(self, value: Any, timeout: float = 30.0) -> None:
        from ray_tpu_torch.core.worker import CoreWorker

        CoreWorker.current().chan_write(self, value, timeout)

    def read(self, reader_idx: int = 0, timeout: float = 30.0) -> Any:
        from ray_tpu_torch.core.worker import CoreWorker

        return CoreWorker.current().chan_read(self.name, reader_idx,
                                              timeout)

    def close(self) -> None:
        from ray_tpu_torch.core.worker import CoreWorker

        core = CoreWorker._current
        if core is not None and not core._shutdown:
            core.chan_close(self)

    def destroy(self) -> None:
        self.close()
