"""Append-only write-ahead log for head control-plane mutations.

The port's copy of ``ray_tpu/_private/wal.py``.

Closes the snapshot-cadence loss window (reference: the GCS persists
every metadata mutation synchronously to Redis,
``src/ray/gcs/store_client/redis_store_client.h``; here the periodic
snapshot is the checkpoint and this WAL covers the mutations since).

Records are appended and flushed BEFORE the head replies to a mutating
RPC: a SIGKILLed head loses nothing the client was told succeeded —
flush() puts frames in the kernel page cache, which survives process
death (power loss is out of scope, matching a local-Redis deployment).

Generation scheme: appends go to ``wal/wal.<gen>``. Taking a snapshot
ROLLS to a fresh generation first, so the snapshot (stamped with the
new generation) covers every record in older files, which are deleted
once the snapshot hits disk. Restore = load snapshot, then replay all
generations >= its stamp, tolerating a torn final frame (kill mid-
append)."""
from __future__ import annotations

import os
import pickle
import struct
from typing import Iterator, List


class HeadWAL:
    def __init__(self, session_dir: str):
        self.dir = os.path.join(session_dir, "wal")
        os.makedirs(self.dir, exist_ok=True)
        self.gen = 0
        self._f = None

    def _path(self, gen: int) -> str:
        return os.path.join(self.dir, f"wal.{gen:08d}")

    def existing_gens(self) -> List[int]:
        out = []
        try:
            for name in os.listdir(self.dir):
                if name.startswith("wal."):
                    try:
                        out.append(int(name[4:]))
                    except ValueError:
                        pass
        except OSError:
            pass
        return sorted(out)

    def open_active(self):
        """Begin appending to a fresh generation above every existing
        one (older files await replay or the next snapshot's cleanup)."""
        gens = self.existing_gens()
        self.gen = (gens[-1] + 1) if gens else 1
        self._f = open(self._path(self.gen), "ab")

    def roll(self) -> int:
        """Switch appends to the next generation (snapshot capture
        runs between roll() and the next append, on the event loop, so
        the snapshot covers exactly gens < the new one)."""
        if self._f is not None:
            self._f.close()
        self.gen += 1
        self._f = open(self._path(self.gen), "ab")
        return self.gen

    def append(self, rec: dict):
        if self._f is None:
            return
        payload = pickle.dumps(rec, protocol=5)
        pos = self._f.tell()
        try:
            self._f.write(struct.pack("<I", len(payload)) + payload)
            self._f.flush()
        except OSError:
            # A partial frame mid-file would silently END replay there,
            # shadowing every later (acknowledged!) record. Truncate
            # back to the known-good offset before letting the RPC
            # fail unacknowledged.
            try:
                self._f.close()
            except OSError:
                pass
            try:
                self._f = open(self._path(self.gen), "ab")
                self._f.truncate(pos)
            except OSError:
                # Damaged file unrepairable: abandon it for a fresh
                # generation — replay treats its torn tail as that
                # file's end and CONTINUES with later generations, so
                # subsequent acked records stay reachable.
                if self._f is not None:
                    try:
                        self._f.close()  # don't leak the damaged fd
                    except OSError:
                        pass
                try:
                    self._f = open(self._path(self.gen + 1), "ab")
                    self.gen += 1
                except OSError:
                    self._f = None  # no durability until next roll
            raise

    def replay_from(self, first_gen: int) -> Iterator[dict]:
        """Records of every generation >= ``first_gen``, in append
        order. A torn tail (kill -9 mid-append, or a file abandoned
        after an unrepairable failed append) ends that file's replay;
        later generations still replay."""
        for g in self.existing_gens():
            if g < first_gen:
                continue
            try:
                with open(self._path(g), "rb") as f:
                    data = f.read()
            except OSError:
                continue
            off = 0
            while off + 4 <= len(data):
                (n,) = struct.unpack_from("<I", data, off)
                if off + 4 + n > len(data):
                    break  # torn final frame
                try:
                    yield pickle.loads(data[off + 4:off + 4 + n])
                except Exception:  # noqa: BLE001 - corrupt frame ends file
                    break
                off += 4 + n

    def drop_below(self, gen: int):
        """Delete generations fully covered by a persisted snapshot."""
        for g in self.existing_gens():
            if g < gen and g != self.gen:
                try:
                    os.unlink(self._path(g))
                except OSError:
                    pass

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
