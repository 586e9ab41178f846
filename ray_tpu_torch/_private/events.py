"""Crash-durable flight recorder: each process's last N structured events
in a preallocated, memory-mapped ring file, readable from disk after the
process died (``ray_tpu/_private/events.py``).

The byte format is the reference's, so a ring written by either package
reads back in the other (``read_ring`` here or there, or
``tools/rtblackbox``): the magic ``RTEVRING1``, a header of ``<10sHIIIdd36s64s``
(magic, version, slot size, slot count, pid, wall and monotonic anchors,
host boot id, process label) in a 4096-byte page, then fixed slots of
``<QII`` (seq, payload length, CRC32) and a pickle protocol 4 payload
``(mono, wall, kind, attrs)``.

A slot commits payload, then length and CRC, then seq last, so a process
killed between any two stores leaves exactly one torn slot, which the
reader counts and skips. Stores go to the page cache, which outlives the
process (not a power loss).

``emit(kind, **attrs)`` records one event. The engine's driver loop uses
``driver_emit``: the same fast path with a tighter per-kind rate cap.
Both are a no-op, after one global load, while the recorder is off:
nothing is pickled and no ring is built. The recorder is on when
``RT_EVENTS_DIR`` names a directory or after :func:`init`. Per-kind token
buckets (500/s, 200/s for ``driver_emit``, each with a burst of 2x) keep
a dispatch storm from flooding the ring: what a cap drops is counted per
kind, in :func:`stats` and in the port's
``serve_metrics()["events_dropped"]``.

The correlation attributes are the reference's: ``request=`` (the
request id), ``lane=`` and ``epoch=`` (the engine driver's restart
generation); an event whose attributes do not fit a slot keeps only
these and ``truncated=True``.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Dict, Optional

#: Environment switch: a directory enables the recorder in every process
#: that inherits the environment. Unset = the recorder is off.
EVENTS_DIR_ENV = "RT_EVENTS_DIR"

#: Ring geometry: 4096 slots of 512 bytes, a 2 MiB file plus one header
#: page per process.
DEFAULT_SLOTS = 4096
DEFAULT_SLOT_SIZE = 512
HEADER_SIZE = 4096

#: Per-kind token-bucket caps (events/second sustained; burst is 2x).
DEFAULT_RATE_PER_S = 500.0
DRIVER_RATE_PER_S = 200.0

_MAGIC = b"RTEVRING1\0"
#: Header: magic, version, slot_size, n_slots, pid, wall anchor,
#: monotonic anchor, boot id (36 ascii), process label (64 utf-8).
_HEADER = struct.Struct("<10sHIIIdd36s64s")
#: Slot prefix: seq (0 = never committed), payload length, CRC32.
_SLOT = struct.Struct("<QII")


def _boot_id() -> str:
    """Host boot identity: monotonic clocks compare exactly within one
    boot of one machine."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()[:36]
    except OSError:
        return ""


class Recorder:
    """One process's ring writer. Thread-safe: submitting threads and the
    engine's driver thread emit, so the slot claim and store run under
    one short mutex (a memcpy into the page cache, no I/O)."""

    def __init__(self, path: str, proc: str = "", *,
                 n_slots: int = DEFAULT_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 rate_per_s: float = DEFAULT_RATE_PER_S):
        import mmap

        self.path = path
        self.proc = proc or f"proc-{os.getpid()}"
        self.n_slots = int(n_slots)
        self.slot_size = int(slot_size)
        self.rate_per_s = float(rate_per_s)
        size = HEADER_SIZE + self.n_slots * self.slot_size
        # The whole ring up front: emit never extends the file, and a
        # full disk fails here, not in a hot loop.
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._lock = threading.Lock()
        self._seq = 0                      # last committed seq
        self.emitted = 0
        self.dropped: Dict[str, int] = {}  # kind -> rate-capped drops
        self.truncated = 0                 # attrs too big for a slot
        self._buckets: Dict[str, list] = {}  # kind -> [tokens, last_t]
        self.wall_anchor = time.time()
        self.mono_anchor = time.monotonic()
        self._mm[0:_HEADER.size] = _HEADER.pack(
            _MAGIC, 1, self.slot_size, self.n_slots, os.getpid(),
            self.wall_anchor, self.mono_anchor,
            _boot_id().encode("ascii", "replace").ljust(36, b"\0")[:36],
            self.proc.encode("utf-8", "replace").ljust(64, b"\0")[:64])

    def emit(self, kind: str, attrs: Dict[str, Any],
             rate_per_s: Optional[float] = None) -> bool:
        """Record one event; False when the kind's rate cap dropped it.
        Never raises: the recorder must not take down what it observes."""
        mono = time.monotonic()
        with self._lock:
            if not self._take_token(kind, mono, rate_per_s):
                self.dropped[kind] = self.dropped.get(kind, 0) + 1
                _count_dropped(kind)
                return False
            seq = self._seq + 1
            payload = self._encode(kind, mono, attrs)
            off = HEADER_SIZE + ((seq - 1) % self.n_slots) * self.slot_size
            try:
                # Invalidate, payload, length+CRC, seq LAST: a kill
                # between any two stores leaves a slot the reader
                # rejects.
                self._mm[off:off + 8] = b"\0" * 8
                body = off + _SLOT.size
                self._mm[body:body + len(payload)] = payload
                self._mm[off + 8:off + _SLOT.size] = struct.pack(
                    "<II", len(payload), zlib.crc32(payload))
                self._mm[off:off + 8] = struct.pack("<Q", seq)
            except (OSError, ValueError):
                return False
            self._seq = seq
            self.emitted += 1
            return True

    def _take_token(self, kind: str, now: float,
                    rate_per_s: Optional[float]) -> bool:
        """Per-kind token bucket, under ``_lock``: sustained ``rate_per_s``,
        burst 2x."""
        rate = self.rate_per_s if rate_per_s is None else float(rate_per_s)
        if rate <= 0:
            return True
        b = self._buckets.get(kind)
        if b is None:
            self._buckets[kind] = [2.0 * rate - 1.0, now]
            return True
        b[0] = min(2.0 * rate, b[0] + (now - b[1]) * rate)
        b[1] = now
        if b[0] < 1.0:
            return False
        b[0] -= 1.0
        return True

    def _encode(self, kind: str, mono: float,
                attrs: Dict[str, Any]) -> bytes:
        wall = time.time()
        cap = self.slot_size - _SLOT.size
        try:
            payload = pickle.dumps((mono, wall, kind, attrs), protocol=4)
        except Exception:  # noqa: BLE001 - unpicklable attr value
            payload = None
        if payload is None or len(payload) > cap:
            # Too big or unpicklable: keep the correlation ids only, so
            # the record still joins its request's timeline.
            self.truncated += 1
            core = {k: attrs[k] for k in ("request", "lane", "epoch")
                    if k in attrs}
            core["truncated"] = True
            payload = pickle.dumps((mono, wall, kind, core), protocol=4)
            payload = payload[:cap] if len(payload) <= cap else \
                pickle.dumps((mono, wall, kind,
                              {"truncated": True}), protocol=4)
        return payload

    def fill(self) -> float:
        """Fraction of the ring holding live records."""
        return min(self._seq, self.n_slots) / float(self.n_slots)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": True, "path": self.path,
                    "ring_fill": round(self.fill(), 4),
                    "emitted": self.emitted,
                    "truncated": self.truncated,
                    "dropped": dict(self.dropped),
                    "dropped_total": sum(self.dropped.values())}

    def close(self):
        with self._lock:
            try:
                self._mm.close()
            except (OSError, ValueError):
                pass


# ------------------------------------------------------------- module API
_init_lock = threading.Lock()
_recorder: Optional[Recorder] = None
#: False until the environment has been read, True after: a process with
#: the recorder off pays one global load and one branch per emit.
_resolved = False


def ring_path(directory: str, proc: str = "") -> str:
    """Per-process ring file: process label, pid and a start stamp, so a
    recycled pid never reuses a dead process's ring."""
    label = (proc or "proc").replace(os.sep, "_")
    return os.path.join(
        directory, f"{label}-{os.getpid()}-{int(time.time() * 1000)}.evr")


def _default_proc_label() -> str:
    import sys

    base = os.path.basename(sys.argv[0] or "py").rsplit(".py", 1)[0]
    return base or "py"


def init(directory: Optional[str] = None, proc: str = "",
         **kw) -> Optional[Recorder]:
    """Enable the recorder for this process, into ``directory`` or else
    ``RT_EVENTS_DIR``; None (off) when neither is set or the directory
    cannot be written. Idempotent: a second call returns the live
    recorder."""
    global _recorder, _resolved
    with _init_lock:
        if _recorder is not None:
            return _recorder
        directory = directory or os.environ.get(EVENTS_DIR_ENV)
        if not directory:
            _resolved = True
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            _recorder = Recorder(
                ring_path(directory, proc or _default_proc_label()),
                proc or _default_proc_label(), **kw)
        except Exception:  # noqa: BLE001 - an unwritable directory
            # turns the recorder off; it never breaks the process.
            _recorder = None
        _resolved = True
        return _recorder


def enabled() -> bool:
    return (_recorder if _resolved else init()) is not None


def emit(kind: str, **attrs) -> bool:
    """Record one event (rate-capped per kind); a no-op while the
    recorder is off."""
    rec = _recorder
    if rec is None:
        if _resolved:
            return False
        rec = init()
        if rec is None:
            return False
    return rec.emit(kind, attrs)


def driver_emit(kind: str, **attrs) -> bool:
    """:func:`emit` for the engine's driver loop: the tighter cap
    ``DRIVER_RATE_PER_S``; never raises, never blocks beyond the
    recorder's mutex."""
    rec = _recorder
    if rec is None:
        if _resolved:
            return False
        rec = init()
        if rec is None:
            return False
    return rec.emit(kind, attrs, rate_per_s=DRIVER_RATE_PER_S)


def stats() -> Dict[str, Any]:
    """This process's recorder health (ring fill, per-kind drops): the
    engine's ``stats()["events"]``."""
    rec = _recorder
    if rec is None:
        return {"enabled": False}
    return rec.stats()


def recorder() -> Optional[Recorder]:
    return _recorder


def _reset_for_tests():
    """Close and drop the process's recorder, so the next emit reads the
    environment again (tests and benchmarks)."""
    global _recorder, _resolved
    with _init_lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = None
        _resolved = False


def _count_dropped(kind: str):
    """Mirror a rate-capped drop into the port's
    ``rt_events_dropped_total``; runs under the recorder's lock."""
    try:
        from .metrics import serve_metrics

        serve_metrics()["events_dropped"].inc(labels={"kind": kind})
    except Exception:  # noqa: BLE001 - metrics must never break emit
        pass


# ------------------------------------------------------------- ring read
def read_ring(path: str) -> Dict[str, Any]:
    """Read one ring file back into ``{"proc", "pid", "wall_anchor",
    "mono_anchor", "boot_id", "events": [...], "torn": n, ...}``. Events
    carry ``seq``, ``mono``, ``wall``, ``kind`` and ``attrs``, in seq
    order. A slot whose seq is stamped but whose CRC or pickle does not
    check out is counted in ``torn`` and skipped."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEADER.size or not data.startswith(_MAGIC):
        raise ValueError(f"{path} is not an rtevents ring file")
    (_, version, slot_size, n_slots, pid, wall_anchor, mono_anchor,
     boot, proc) = _HEADER.unpack_from(data, 0)
    out = {
        "path": path, "version": version,
        "proc": proc.rstrip(b"\0").decode("utf-8", "replace"),
        "pid": pid, "wall_anchor": wall_anchor,
        "mono_anchor": mono_anchor,
        "boot_id": boot.rstrip(b"\0").decode("ascii", "replace"),
        "n_slots": n_slots, "slot_size": slot_size,
        "events": [], "torn": 0,
    }
    for i in range(n_slots):
        off = HEADER_SIZE + i * slot_size
        if off + _SLOT.size > len(data):
            break
        seq, length, crc = _SLOT.unpack_from(data, off)
        if seq == 0:
            continue
        body = data[off + _SLOT.size:off + _SLOT.size + length]
        if length > slot_size - _SLOT.size or len(body) < length \
                or zlib.crc32(body) != crc:
            out["torn"] += 1
            continue
        try:
            mono, wall, kind, attrs = pickle.loads(body)
        except Exception:  # noqa: BLE001 - torn payload, same tolerance
            out["torn"] += 1
            continue
        out["events"].append({"seq": seq, "mono": mono, "wall": wall,
                              "kind": kind, "attrs": attrs})
    out["events"].sort(key=lambda e: e["seq"])
    return out
