"""A pool of rank processes on one host, each joined to one process
group: the single-host way to run the port's SPMD programs (a sharded
training step, a collective) from a controller that is not a rank.

``RankPool(n, devices)`` spawns ``n`` processes; each sets its device,
joins ``torch.distributed`` (gloo, or NCCL with one card per rank) on a
``FileStore`` of the pool's own, and then runs whatever ``pool.run(fn,
*args)`` sends it: every rank calls ``fn(*args)`` (``fn`` importable by
name, as ``spawn`` pickles it) and ``run`` returns the ranks' results in
rank order. A script that makes a pool needs an ``if __name__ ==
"__main__":`` guard (spawn re-imports the main file).

A rank that raises reports its traceback; ``run`` then raises with
every rank's report and closes the pool, since its other ranks may wait
in a collective that will never complete (each one's timeout ends the
wait). Across hosts, start one process per rank yourself (``torchrun``)
and call :func:`ray_tpu_torch.parallel.initialize_multihost`.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import traceback
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device, set_matmul_precision

#: Seconds each rank's process group waits in a collective.
TIMEOUT_S = 120.0
#: Seconds a rank may take to start (spawn, import torch, reach its
#: device); several test processes may be starting at once.
START_TIMEOUT_S = 300.0
#: Intra-op threads of a rank process: several share a host.
RANK_THREADS = 2


class RankPool:
    """``world_size`` rank processes on ``devices`` (default one card
    each, ``cuda:0..n-1``; ``("cpu",) * n`` for the CPU). ``backend``
    defaults to NCCL on distinct cards, else gloo. ``timeout_s`` bounds
    every collective of the default group."""

    def __init__(self, world_size: int,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 backend: Optional[str] = None,
                 timeout_s: float = TIMEOUT_S):
        n = int(world_size)
        if devices is None:
            resolve_device(None)
            if torch.cuda.device_count() < n:
                raise RuntimeError(
                    f"{n} ranks need {n} cards, {torch.cuda.device_count()}"
                    f" are visible; pass devices=('cuda:0',) * {n} to share "
                    f"one (gloo)")
            devices = [f"cuda:{i}" for i in range(n)]
        self.devices = tuple(str(torch.device(d)) for d in devices)
        if len(self.devices) != n:
            raise ValueError(f"{n} ranks need {n} devices, got "
                             f"{self.devices}")
        cuda = all(torch.device(d).type == "cuda" for d in self.devices)
        if backend is None:
            backend = "nccl" if cuda and len(set(self.devices)) == n \
                else "gloo"
        self.backend, self.timeout_s = backend, float(timeout_s)
        self.closed = False
        self._procs: list = []
        self._conns: list = []
        self._dir = tempfile.mkdtemp(prefix="rt-torch-ranks-")
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(n):
                here, there = ctx.Pipe()
                p = ctx.Process(target=_rank_main, daemon=True,
                                name=f"rt-torch-rank{r}of{n}",
                                args=(os.path.join(self._dir, "store"), r,
                                      self.devices, backend, self.timeout_s,
                                      there))
                p.start()
                there.close()
                self._procs.append(p)
                self._conns.append(here)
            ready = self._collect(START_TIMEOUT_S + self.timeout_s)
            bad = [f"rank {r}: {m}" for r, m in enumerate(ready)
                   if m != ("ok", "ready")]
            if bad:
                raise RuntimeError("ranks did not start:\n" + "\n".join(
                    map(str, bad)))
        except BaseException:
            self.close()
            raise
        atexit.register(self.close)

    def _collect(self, timeout: float) -> List[Any]:
        out = []
        for r, conn in enumerate(self._conns):
            try:
                msg = pickle.loads(conn.recv_bytes()) if conn.poll(timeout) \
                    else ("err", f"no answer within {timeout:.0f} s")
            except (EOFError, OSError):
                msg = ("err", "the process exited")
            out.append(msg)
        return out

    def run(self, fn, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; their results in rank
        order (results travel pickled: return host values)."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        msg = pickle.dumps(("run", fn, args, kwargs),
                           pickle.HIGHEST_PROTOCOL)
        for conn in self._conns:
            conn.send_bytes(msg)
        res = self._collect(2 * self.timeout_s + 60.0)
        if any(kind != "ok" for kind, _ in res):
            self.close()
            raise RuntimeError(
                f"{getattr(fn, '__name__', fn)} failed on the rank pool "
                f"({self.backend} on {self.devices}), which was closed:\n"
                + "\n".join(f"rank {r}: {v}" for r, (kind, v)
                            in enumerate(res) if kind != "ok"))
        return [v for _, v in res]

    def close(self) -> None:
        """Stop the ranks (one that has not exited within 5 s is
        terminated) and remove the store's directory. Idempotent."""
        if self.closed:
            return
        self.closed = True
        for conn in self._conns:
            try:
                conn.send_bytes(pickle.dumps(("close",)))
            except OSError:
                pass
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rank_main(store: str, rank: int, devices: Sequence[str], backend: str,
               timeout_s: float, conn) -> None:
    """A rank's life: join the process group, then run what arrives until
    the pool closes or its end of the pipe does."""
    torch.set_num_threads(RANK_THREADS)

    def reply(kind, value):
        try:
            conn.send_bytes(pickle.dumps((kind, value),
                                         pickle.HIGHEST_PROTOCOL))
        except Exception:  # noqa: BLE001 - an unpicklable result
            conn.send_bytes(pickle.dumps(("err", traceback.format_exc())))

    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        set_matmul_precision(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:  # noqa: BLE001 - reported to the controller
        reply("err", traceback.format_exc())
        return
    reply("ok", "ready")
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            break                        # the controller closed or died
        if msg[0] == "close":
            break
        _, fn, args, kwargs = msg
        try:
            reply("ok", fn(*args, **kwargs))
        except Exception:  # noqa: BLE001 - reported to the controller
            reply("err", traceback.format_exc())
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - leaving anyway
        pass
    sys.stdout.flush()
