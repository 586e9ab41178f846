"""Binary IDs for jobs, tasks, objects, actors, nodes, placement groups.

The port's copy of ``ray_tpu/_private/ids.py``.

Capability parity with the reference's ID scheme (reference:
``src/ray/common/id.h``, ``id_def.h``) but designed fresh: every ID is a
fixed-width random byte string with a 1-byte type tag, so IDs are
self-describing on the wire and sortable by creation when the time prefix is
enabled.
"""
from __future__ import annotations

import os
import threading
import time

_ID_LEN = 16  # bytes, excluding the 1-byte type tag

_TYPE_JOB = 0x01
_TYPE_TASK = 0x02
_TYPE_OBJECT = 0x03
_TYPE_ACTOR = 0x04
_TYPE_NODE = 0x05
_TYPE_PLACEMENT_GROUP = 0x06
_TYPE_WORKER = 0x07

_counter_lock = threading.Lock()
_counter = 0


# Burst-submission hot path: os.urandom per ID costs ~0.1ms via a
# syscall. A per-process random seed + atomic counter keeps IDs unique
# at ~no cost per ID. Layout matters: ``ObjectID.for_task_return``
# truncates the FINAL 2 bytes, so both the counter (intra-process
# uniqueness) and the seed (cross-process uniqueness, 4 bytes + pid mixed
# in) must sit in the first 8 of these 10 bytes.
_proc_seed = bytes(a ^ b for a, b in zip(
    os.urandom(6), os.getpid().to_bytes(6, "big", signed=False)))
# itertools.count.__next__ is a single C call — atomic under the GIL, so
# the hot path needs no lock (a lock acquire/release pair costs more
# than the whole ID otherwise).
import itertools as _itertools

_seq_iter = _itertools.count(1)


# (ms, 6-byte big-endian prefix) as ONE atomically-assigned tuple:
# concurrent submitters read it with a single load, so a reader can
# never pair one thread's ms with another thread's byte string (the
# torn read two separate globals allowed).
_ts_cache = (0, b"\x00" * 6)


def _rand_bytes(n: int) -> bytes:
    if n == 10:
        s = next(_seq_iter) & 0xFFFFFFFF
        return _proc_seed[:4] + s.to_bytes(4, "big") + _proc_seed[4:6]
    return os.urandom(n)


class BaseID:
    """A fixed-width binary identifier. Immutable and hashable."""

    _type_tag = 0x00
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != _ID_LEN + 1:
            raise ValueError(
                f"{type(self).__name__} requires {_ID_LEN + 1} bytes, got {len(id_bytes)}"
            )
        if id_bytes[0] != self._type_tag:
            raise ValueError(
                f"Wrong type tag for {type(self).__name__}: {id_bytes[0]:#x}"
            )
        self._bytes = id_bytes

    @classmethod
    def from_random(cls) -> "BaseID":
        # 6-byte coarse timestamp prefix keeps IDs roughly creation-ordered,
        # which makes store scans and debugging nicer; the remaining bytes are
        # cryptographically random. The prefix is CACHED per millisecond:
        # submission bursts mint thousands of IDs per ms and the
        # int->to_bytes pair showed up in the submit-path profile.
        global _ts_cache
        now = int(time.time() * 1000)
        ms, prefix = _ts_cache
        if now != ms:
            prefix = now.to_bytes(6, "big", signed=False)[-6:]
            _ts_cache = (now, prefix)
        return cls(bytes([cls._type_tag]) + prefix
                   + _rand_bytes(_ID_LEN - 6))

    @classmethod
    def from_hex(cls, h: str) -> "BaseID":
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(bytes([cls._type_tag]) + b"\x00" * _ID_LEN)

    def is_nil(self) -> bool:
        return self._bytes[1:] == b"\x00" * _ID_LEN

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:14]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    _type_tag = _TYPE_JOB
    __slots__ = ()


class TaskID(BaseID):
    _type_tag = _TYPE_TASK
    __slots__ = ()


class ObjectID(BaseID):
    _type_tag = _TYPE_OBJECT
    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Deterministically derive the i-th return object ID of a task."""
        body = task_id.binary()[1 : 1 + _ID_LEN - 2] + index.to_bytes(2, "big")
        return cls(bytes([cls._type_tag]) + body)


class ActorID(BaseID):
    _type_tag = _TYPE_ACTOR
    __slots__ = ()


class NodeID(BaseID):
    _type_tag = _TYPE_NODE
    __slots__ = ()


class WorkerID(BaseID):
    _type_tag = _TYPE_WORKER
    __slots__ = ()


class PlacementGroupID(BaseID):
    _type_tag = _TYPE_PLACEMENT_GROUP
    __slots__ = ()
