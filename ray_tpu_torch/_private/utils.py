"""Small shared helpers for process spawning.

The port's copy of ``ray_tpu/_private/utils.py``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional


def spawn_env_with_pkg_root(extra: Optional[Dict[str, str]] = None
                            ) -> Dict[str, str]:
    """Environment for spawned daemon/worker processes: guarantees the
    ray_tpu_torch package root is importable regardless of the parent's cwd."""
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + pp if pp else "")
    if extra:
        env.update(extra)
    return env


def session_shm_domain(session_dir: str) -> str:
    """Default shm domain for a session: host-scoped AND session-scoped.

    Every process of one session on one host derives the same value
    (head, head-local workers, UDS-attached drivers), so they exchange
    large objects through shared memory — while two sessions on one
    machine can never collide on segment names, and a head's clean
    shutdown may sweep its own domain's leftovers (SIGKILLed workers
    skip unlink) without touching anyone else's.
    """
    import socket

    return f"{socket.gethostname()}.{os.path.basename(session_dir.rstrip('/'))}"


def process_exited(pid: int) -> bool:
    """True if ``pid`` no longer runs — counting zombies as exited (an
    unreaped child still answers ``kill(pid, 0)``, so signal-0 probing
    lies to anyone who isn't the parent)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            # field 3 is the state; comm (field 2) may contain spaces
            # and parens, so split on the LAST ')'
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except PermissionError:
        # hidepid mounts deny stat on other users' pids — the process
        # EXISTS (ENOENT is how absence presents), so report alive.
        return False
    except (OSError, IndexError):
        # IndexError: stat read raced final teardown (empty/partial
        # content instead of ESRCH on some kernels) — gone either way.
        if not os.path.isdir("/proc"):
            # No procfs at all (macOS, some containers): fall back to
            # signal-0 probing — blind to zombies, but better than
            # declaring every process exited.
            try:
                os.kill(pid, 0)
                return False
            except ProcessLookupError:
                return True
            except OSError:
                return False  # EPERM: exists, owned by someone else
        return True
