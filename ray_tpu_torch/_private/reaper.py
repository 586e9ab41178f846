"""Orphan-proofing for cluster processes.

The port's copy of ``ray_tpu/_private/reaper.py``.

The reference keeps worker trees from outliving a killed raylet with a
child-subreaper (reference: ``src/ray/util/subreaper.h``); the same
problem here is a SIGKILL'd driver/head/node daemon leaving workers
alive forever (and skewing every benchmark on a shared machine). Three
layers, all Linux-first with safe no-op fallbacks:

- ``die_with_parent()`` — prctl(PR_SET_PDEATHSIG, SIGKILL): the kernel
  kills us the instant the spawning thread's process exits, covering
  SIGKILL where no atexit hook can run.
- an orphan watchdog thread — polls ``os.getppid()``; re-parenting to
  init (or to a subreaper we did not start under) means the parent died
  in the exec window before prctl took effect.
- ``become_subreaper()`` — prctl(PR_SET_CHILD_SUBREAPER, 1) in heads and
  node daemons, so grandchildren re-parent to us (not init) and get
  reaped/killed on our shutdown instead of leaking.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import signal
import threading

PR_SET_PDEATHSIG = 1
PR_SET_CHILD_SUBREAPER = 36

_libc = None


def _prctl(option: int, arg: int) -> bool:
    global _libc
    if os.name != "posix":
        return False
    try:
        if _libc is None:
            _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                                use_errno=True)
        return _libc.prctl(option, arg, 0, 0, 0) == 0
    except Exception:  # noqa: BLE001 - non-Linux libc; degrade to no-op
        return False


EXPECTED_PPID_ENV = "RT_EXPECTED_PPID"


def die_with_parent(sig: int = signal.SIGKILL) -> bool:
    """Ask the kernel to deliver ``sig`` when our parent process dies.

    Must be called early in the child (after exec). Returns True if the
    prctl took effect. The exec-window race (parent died before this
    call → signal never fires) is only detectable against an explicit
    spawner pid: spawners put their pid in ``RT_EXPECTED_PPID``; a bare
    ``getppid()==1`` check would SIGKILL healthy workers whenever the
    spawner legitimately runs as PID 1 (container entrypoint).
    """
    ok = _prctl(PR_SET_PDEATHSIG, sig)
    expected = os.environ.get(EXPECTED_PPID_ENV)
    if expected and os.getppid() != int(expected):
        # Parent died in the exec window; the death signal missed.
        os.kill(os.getpid(), sig)
    return ok


def become_subreaper() -> bool:
    """Adopt orphaned grandchildren instead of letting init take them."""
    return _prctl(PR_SET_CHILD_SUBREAPER, 1)


def start_orphan_watchdog(interval: float = 2.0,
                          sig: int = signal.SIGKILL) -> threading.Thread:
    """Kill this process if it gets re-parented away from its spawner.

    Belt for the pdeathsig braces: catches the exec-window race and
    platforms where prctl is unavailable. The legitimate parent is the
    spawner-provided ``RT_EXPECTED_PPID`` when present (immune to the
    exec-window race), else the initial ``getppid``; any change (init, a
    systemd user reaper, ...) means that parent is gone.
    """
    expected = os.environ.get(EXPECTED_PPID_ENV)
    original_ppid = int(expected) if expected else os.getppid()
    stop = threading.Event()

    def watch():
        while not stop.wait(interval):
            if os.getppid() != original_ppid:
                os.kill(os.getpid(), sig)
                return

    t = threading.Thread(target=watch, name="orphan-watchdog", daemon=True)
    t.start()
    return t
