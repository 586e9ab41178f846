"""Dual-tier object store: in-process memory store + host shared memory.

The port's copy of ``ray_tpu/_private/object_store.py``.

Capability parity with the reference's split between the core-worker memory
store for small objects and the plasma shared-memory store for large ones
(reference: ``src/ray/core_worker/store_provider/memory_store/memory_store.h:43``
vs ``plasma_store_provider.h:88``, plasma arena ``src/ray/object_manager/plasma/``),
re-designed for this runtime:

- Objects are stored as *frame lists* (pickle-5 header/body + out-of-band
  buffers) so numpy/jax host buffers round-trip zero-copy.
- Small objects (<= ``max_inline_object_size``) live in the owner process and
  travel inline in task specs / replies.
- Large objects are written once into a named POSIX shared-memory segment;
  any process on the host maps it read-only (zero-copy ``np.frombuffer``
  views). On a GPU host it is the staging area the consumer copies
  to its card from (``utils/device.device_put_shm``).
- Spilling: segments overflow to disk files under the spill directory when
  the shm budget is exhausted (LRU by insertion order).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from multiprocessing import shared_memory, resource_tracker
from typing import Dict, List, Optional

from .ids import ObjectID
from .serialization import pack_frames, unpack_frames

#: Segment names start with this, then the shm domain's hash. The
#: reference names its segments ``rt_…``: a sweep by either package's
#: head matches only its own package's segments, so the two runtimes can
#: share a host (and a test run) without unlinking each other's objects.
SEGMENT_PREFIX = "rtt_"


def _open_shm(name: str, create: bool = False, size: int = 0):
    """Open a shm segment WITHOUT resource-tracker registration.

    The stdlib tracker unlinks segments when *any* attaching process exits;
    for a cross-process store only the owner may unlink, so we suppress
    registration entirely (this store manages lifetimes itself).
    """
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name, create=create, size=size)
    finally:
        resource_tracker.register = orig


def sweep_domain_segments(domain: str) -> int:
    """Unlink every shm segment of one shm DOMAIN (its name prefix is
    derived from the domain string). For synthetic per-cluster domains
    this is safe teardown hygiene — SIGKILL chaos leaves segments whose
    creators died without unlinking; nothing outside the owning cluster
    can hold that domain. Never call it for the shared host domain.
    Returns the number of segments removed."""
    import hashlib

    prefix = SEGMENT_PREFIX + hashlib.sha1(
        domain.encode()).hexdigest()[:6] + "_"
    removed = 0
    try:
        for name in os.listdir("/dev/shm"):
            if name.startswith(prefix):
                try:
                    os.unlink(os.path.join("/dev/shm", name))
                    removed += 1
                except OSError:
                    pass
    except OSError:
        pass
    return removed


class MemoryStore:
    """In-process object store with blocking waiters (thread-safe).

    Two wake-up mechanisms: a per-object event for ``get`` blockers, and
    registered multi-object watcher events so ``wait()`` over N refs parks
    on ONE event instead of polling (reference: event-driven
    ``CoreWorker::Wait``, ``core_worker.cc:1735``).
    """

    def __init__(self):
        self._objects: Dict[ObjectID, List[bytes]] = {}
        # RLock: ObjectRef.__del__ (cyclic GC) can re-enter delete() while
        # this thread is inside put()/get() — a plain Lock would self-deadlock.
        self._lock = threading.RLock()
        self._events: Dict[ObjectID, threading.Event] = {}
        self._watchers: Dict[ObjectID, List[threading.Event]] = {}

    def put(self, object_id: ObjectID, frames: List[bytes]) -> None:
        with self._lock:
            self._objects[object_id] = frames
            ev = self._events.pop(object_id, None)
            watchers = self._watchers.pop(object_id, ())
        if ev:
            ev.set()
        for w in watchers:
            w.set()

    def put_many(self, items) -> None:
        """Store ``[(object_id, frames), ...]`` under one lock pass —
        reply ingestion lands whole chunks at once."""
        to_set = []
        with self._lock:
            for object_id, frames in items:
                self._objects[object_id] = frames
                ev = self._events.pop(object_id, None)
                if ev:
                    to_set.append(ev)
                to_set.extend(self._watchers.pop(object_id, ()))
        for ev in to_set:
            ev.set()

    def add_watcher(self, object_id: ObjectID, ev: threading.Event) -> None:
        """Fire ``ev`` when the object arrives (immediately if present)."""
        with self._lock:
            if object_id in self._objects:
                ev.set()
                return
            self._watchers.setdefault(object_id, []).append(ev)

    def remove_watcher(self, object_id: ObjectID, ev: threading.Event) -> None:
        with self._lock:
            ws = self._watchers.get(object_id)
            if ws is not None:
                try:
                    ws.remove(ev)
                except ValueError:
                    pass
                if not ws:
                    self._watchers.pop(object_id, None)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get_many(self, object_ids) -> dict:
        """Snapshot whichever of ``object_ids`` are present — one lock
        pass for a whole ``get([refs])`` burst."""
        out = {}
        with self._lock:
            objs = self._objects
            for oid in object_ids:
                frames = objs.get(oid)
                if frames is not None:
                    out[oid] = frames
        return out

    def get(self, object_id: ObjectID, timeout: Optional[float] = None):
        with self._lock:
            if object_id in self._objects:
                return self._objects[object_id]
            ev = self._events.setdefault(object_id, threading.Event())
        if not ev.wait(timeout):
            return None
        with self._lock:
            return self._objects.get(object_id)

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._objects.pop(object_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)


class SharedMemoryStore:
    """Host-wide store of immutable objects in named shm segments.

    The *owner* process creates segments and is responsible for unlinking.
    Reader processes attach by name (zero-copy).
    """

    #: Default lifetime of a pending (create_pending → seal/abort)
    #: reservation. A puller that dies between reserve and seal — the
    #: task cancelled so hard its abort never ran, a thread killed by a
    #: process-level fault — would otherwise pin its reserved bytes
    #: (and squat the segment name) forever; the sweep reclaims on the
    #: same lease-clock discipline as the serve handoff plane
    #: Generous against the slowest legitimate
    #: transfer: GiB-scale pulls finish in seconds.
    PENDING_TTL_S = 120.0

    def __init__(self, capacity_bytes: int, spill_dir: str = "",
                 domain: str = "", pending_ttl_s: float = 0.0):
        self._capacity = capacity_bytes
        self._used = 0
        # RLock: see MemoryStore — the GC free path may re-enter delete().
        self._lock = threading.RLock()
        # object_id -> (shm handle or None, nbytes, spilled_path or None)
        self._owned: "OrderedDict[ObjectID, tuple]" = OrderedDict()
        self._attached: Dict[ObjectID, shared_memory.SharedMemory] = {}
        # In-progress chunked transfers (create_pending → seal/abort):
        # object_id -> (shm, nbytes, num_frames, reserved_at)
        self._pending: Dict[ObjectID, tuple] = {}
        self._pending_ttl = float(pending_ttl_s) or self.PENDING_TTL_S
        self._spill_dir = spill_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "rtt_spill"
        )
        # Segment names are scoped by shm domain: processes on the same
        # host (same domain) agree on names and attach each other's
        # segments; different domains — real remote hosts, or synthetic
        # test nodes modelling them — cannot see each other's objects
        # and must go through the transfer protocol.
        import hashlib

        self._prefix = (hashlib.sha1(domain.encode()).hexdigest()[:6] + "_"
                        if domain else "")

    def _name(self, object_id: ObjectID) -> str:
        return SEGMENT_PREFIX + self._prefix + object_id.hex()[:30]

    @staticmethod
    def _clear_if_stale(name: str) -> bool:
        """True if the named segment was a half-written leftover (frame
        count still 0 — a crashed or in-flight chunked pull) and was
        unlinked. A COMPLETE segment is left alone: task results are
        idempotent, the existing copy is the same value."""
        try:
            shm = _open_shm(name)
        except FileNotFoundError:
            return True  # vanished under us: name is free now
        try:
            stale = bytes(shm.buf[:4]) == b"\x00\x00\x00\x00"
            if stale:
                shm.unlink()
            return stale
        finally:
            shm.close()

    def create(self, object_id: ObjectID, frames: List[bytes]) -> int:
        """Write frames into a new segment. Returns total bytes.

        Frames scatter straight into the mapped segment (native codec)
        — no intermediate packed blob, one copy total."""
        from .serialization import pack_frames_into, packed_size

        n = packed_size(frames)
        with self._lock:
            if self._used + n > self._capacity:
                self._spill_lru(self._used + n - self._capacity)
            try:
                shm = _open_shm(self._name(object_id), create=True, size=n)
            except FileExistsError:
                # A half-written leftover (e.g. a pull racing this
                # producer — lineage recovery while a consumer pulls)
                # must NOT suppress the write: readers would wedge on a
                # count-0 segment that no one will ever finish.
                if not self._clear_if_stale(self._name(object_id)):
                    return n  # complete copy already here (idempotent)
                try:
                    shm = _open_shm(self._name(object_id), create=True,
                                    size=n)
                except FileExistsError:
                    return n  # recreated concurrently: defer to it
            pack_frames_into(shm.buf, 0, frames)
            self._owned[object_id] = (shm, n, None)
            self._used += n
        return n

    def create_pending(self, object_id: ObjectID, frame_sizes):
        """Reserve a segment an incoming chunked transfer writes into
        DIRECTLY (no staging buffer — at GiB sizes a second fresh
        allocation measurably hurts, see benchmarks/broadcast_bench.py).
        The size table is written here (this store owns the packed
        layout, shared with ``serialization.unpack_frames``); the caller
        fills the returned PAYLOAD view, then :meth:`seal` publishes.
        Until then the 4-byte frame count is zero, so concurrent
        attachers see not-ready (the ``_safe_unpack`` contract), never
        torn frames. Returns None if the object already has a segment
        (or pending transfer) here."""
        import struct as _struct

        header = _struct.pack("<I", 0) + b"".join(
            _struct.pack("<Q", s) for s in frame_sizes)
        nbytes = len(header) + sum(frame_sizes)
        # Reclaim abandoned reservations FIRST: a crashed puller's
        # leftover must neither hold capacity against this transfer nor
        # squat the segment name it happens to share.
        self.sweep_pending()
        with self._lock:
            if object_id in self._pending:
                # A transfer of this object is already in flight in THIS
                # process; a second writer would corrupt the first's
                # bookkeeping at seal time.
                return None
            if self._used + nbytes > self._capacity:
                self._spill_lru(self._used + nbytes - self._capacity)
            try:
                shm = _open_shm(self._name(object_id), create=True,
                                size=nbytes)
            except FileExistsError:
                return None
            # Reserve now: concurrent pending transfers must see each
            # other's bytes or the store overcommits its capacity.
            self._used += nbytes
            self._pending[object_id] = (shm, nbytes, len(frame_sizes),
                                        time.monotonic())
        shm.buf[4:len(header)] = header[4:]
        return memoryview(shm.buf)[len(header):]

    def seal(self, object_id: ObjectID, view=None) -> None:
        """Publish a pending segment: the frame count lands LAST.

        ``view`` (the payload view ``create_pending`` returned) lets a
        writer prove the entry is still ITS OWN: a puller that stalled
        past the TTL may find its reservation swept — and possibly
        re-created by a retrying writer. Sealing the NEW writer's
        half-written segment would publish torn bytes, so a mismatched
        (or missing) entry raises instead; the caller re-pulls.

        Plain Python stores publish-after-write — like the pure-Python
        ``pack_frames_into`` path, ordering is guaranteed on TSO
        hardware (x86, every supported TPU VM host); weakly-ordered
        CPUs would need the native codec's release fence here."""
        import struct as _struct

        with self._lock:
            ent = self._pending.get(object_id)
            if ent is None:
                raise RuntimeError(
                    f"pending transfer for {object_id} was swept "
                    f"(TTL) or aborted before seal; retry the pull")
            shm, n, num_frames, _t = ent
            if view is not None and view.obj is not shm._mmap:
                raise RuntimeError(
                    f"pending transfer for {object_id} was swept and "
                    f"re-created by another writer; this writer's "
                    f"bytes are gone — retry the pull")
            del self._pending[object_id]
            shm.buf[:4] = _struct.pack("<I", num_frames)
            self._owned[object_id] = (shm, n, None)

    def sweep_pending(self, ttl_s: Optional[float] = None,
                      now: Optional[float] = None) -> int:
        """Abort pending reservations older than the TTL (crashed or
        wedged pullers that never reached seal/abort): their reserved
        bytes return to the capacity budget and their count-0 segments
        unlink so a new writer can claim the name. Returns how many
        were reclaimed. Runs opportunistically on every
        ``create_pending`` (the lease clock needs no dedicated thread);
        ``ttl_s``/``now`` exist for tests."""
        ttl = self._pending_ttl if ttl_s is None else float(ttl_s)
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [oid for oid, ent in self._pending.items()
                       if now - ent[3] > ttl]
        # The abort happens outside the scan lock, so the entry may have
        # been aborted by its own writer and re-created by a NEW one in
        # between — ``stamped_before`` makes abort_pending re-check the
        # expiry under ITS lock (a fresh reservation carries a fresh
        # stamp) instead of tearing down the new writer's segment.
        return sum(1 for oid in expired
                   if self.abort_pending(oid, stamped_before=now - ttl))

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def clear_stale_segment(self, object_id: ObjectID) -> bool:
        """Unlink a half-written (count-0) segment left by a crashed
        transfer so a new writer can claim the name."""
        return self._clear_if_stale(self._name(object_id))

    def abort_pending(self, object_id: ObjectID, view=None,
                      stamped_before: Optional[float] = None) -> bool:
        """Drop a pending segment after a failed transfer. ``view``
        (see :meth:`seal`) guards the swept-and-re-created race: a
        stale writer's abort must not tear down the NEW writer's
        reservation. ``stamped_before`` is the sweeper's equivalent
        guard — only an entry reserved before that monotonic instant is
        aborted. Returns True if an entry was actually dropped."""
        with self._lock:
            ent = self._pending.get(object_id)
            if ent is None:
                return False
            if view is not None and view.obj is not ent[0]._mmap:
                return False    # someone else's reservation now
            if stamped_before is not None and ent[3] >= stamped_before:
                return False    # re-created after the sweep scan
            del self._pending[object_id]
            shm, n = ent[0], ent[1]
            self._used -= n
        # Unlink FIRST (independent of open mappings): close() raises
        # BufferError while the writer's aborted view is still alive,
        # which must not leave the count-0 segment squatting the name.
        # And only unlink if the name still maps to OUR inode — a
        # clobbering producer may have re-created a complete segment
        # under this name (see _clear_if_stale), which must survive.
        try:
            mine = os.fstat(shm._fd).st_ino == os.stat(
                f"/dev/shm/{shm.name.lstrip('/')}").st_ino
        except OSError:
            mine = False  # name already gone or unreadable
        try:
            if mine:
                shm.unlink()
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass
        try:
            shm.close()
        except BufferError:
            pass  # writer's view still alive; fd goes with the process
        return True

    @staticmethod
    def _safe_unpack(buf) -> Optional[List[memoryview]]:
        """A reader can attach between the owner's segment create and its
        frame write and observe zeros or a half-written size table.
        Serialized values always carry ≥2 frames (header + pickle body),
        so fewer — or a malformed table — means not-ready → None, letting
        the caller's wait/pull path retry. Only valid on *attach* paths:
        owned/spilled entries are fully written before registration, so
        malformed data there is corruption and must raise."""
        try:
            frames = unpack_frames(buf)
        except ValueError:
            return None
        if len(frames) < 2:
            return None
        return frames

    def get(self, object_id: ObjectID) -> Optional[List[memoryview]]:
        # Read-only views (reference: plasma buffers are immutable):
        # deserialized numpy/jax arrays alias the segment zero-copy, so
        # a writable view would let user code corrupt the stored value
        # for every other reader.
        with self._lock:
            ent = self._owned.get(object_id)
            if ent is not None:
                shm, n, path = ent
                if shm is not None:
                    return unpack_frames(
                        memoryview(shm.buf)[:n].toreadonly())
                with open(path, "rb") as f:  # spilled
                    return unpack_frames(f.read())
            if object_id in self._attached:
                shm = self._attached[object_id]
                frames = self._safe_unpack(
                    memoryview(shm.buf).toreadonly())
                if frames is not None:
                    return frames
                # Not ready. The mapping may be an orphaned inode (the
                # segment was cleared and re-created under this name by
                # a racing writer): drop it so THIS call re-opens by
                # NAME and sees the live segment.
                self._attached.pop(object_id, None)
        # Attach to a segment owned by another process on this host.
        try:
            shm = _open_shm(self._name(object_id))
        except FileNotFoundError:
            return None
        frames = self._safe_unpack(memoryview(shm.buf).toreadonly())
        if frames is None:
            # Mid-write (count 0): don't cache the mapping — a clobber
            # would strand it on an orphaned inode. No views escaped, so
            # closing is safe.
            try:
                shm.close()
            except BufferError:  # pragma: no cover - paranoia
                pass
            return None
        with self._lock:
            self._attached[object_id] = shm
        return frames

    def contains(self, object_id: ObjectID) -> bool:
        if object_id in self._owned or object_id in self._attached:
            return True
        try:
            shm = _open_shm(self._name(object_id))
        except FileNotFoundError:
            return False
        # Probe only — do NOT cache the mapping (rtlint RT101 real
        # finding, sharpened in review): the old unguarded insert could
        # race delete() and resurrect an entry for a deleted object,
        # and even a locked insert can land AFTER a delete() that ran
        # in the open-to-insert window. No views escaped this probe, so
        # closing is safe; get() re-attaches on demand.
        try:
            shm.close()
        except BufferError:  # pragma: no cover - paranoia
            pass
        return True

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            ent = self._owned.pop(object_id, None)
            if ent:
                shm, n, path = ent
                if shm is not None:
                    self._used -= n
                    try:
                        shm.close()
                        shm.unlink()
                    except Exception:
                        pass
                elif path:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            att = self._attached.pop(object_id, None)
        if att:
            try:
                att.close()
            except Exception:
                pass

    def _spill_lru(self, need_bytes: int) -> None:  # rtlint: holds=_lock
        """Move oldest in-shm objects to disk until need_bytes freed.
        Both call sites (put / create capacity checks) hold _lock."""
        os.makedirs(self._spill_dir, exist_ok=True)
        freed = 0
        for oid in list(self._owned):
            if freed >= need_bytes:
                break
            shm, n, path = self._owned[oid]
            if shm is None:
                continue
            p = os.path.join(self._spill_dir, self._name(oid))
            with open(p, "wb") as f:
                f.write(shm.buf[:n])
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
            self._owned[oid] = (None, n, p)
            self._used -= n
            freed += n

    def used_bytes(self) -> int:
        return self._used

    @staticmethod
    def _defuse(shm: shared_memory.SharedMemory):
        """Close if safe; otherwise leak the mapping to the OS.

        User code may still hold zero-copy numpy views into the segment;
        releasing the exported buffer would raise BufferError, so we drop our
        handles and let process exit unmap it.
        """
        try:
            shm.close()
        except BufferError:
            shm._buf = None  # noqa: SLF001 - deliberate leak of the mapping
            shm._mmap = None  # noqa: SLF001

    def shutdown(self) -> None:
        with self._lock:
            for oid, ent in list(self._owned.items()):
                shm, n, path = ent
                if shm is not None:
                    try:
                        shm.unlink()
                    except Exception:
                        pass
                    self._defuse(shm)
            self._owned.clear()
            for shm in self._attached.values():
                self._defuse(shm)
            self._attached.clear()
