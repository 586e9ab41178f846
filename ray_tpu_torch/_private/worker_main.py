"""Worker process entry point (reference capability: default_worker.py).

The port's copy of ``ray_tpu/_private/worker_main.py``, without the
reference's developer sanitizer hook (``tools.rtsan``): the port loads
nothing of ``tools/``.

Spawned by the head's worker pool (UDS, head-local) or by a node daemon
(TCP, remote node); registers back with the head and then serves
``push_task`` / ``create_actor`` RPCs until terminated.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time


def main():
    import faulthandler

    # `kill -USR1 <worker pid>` dumps thread stacks to the worker log —
    # the debugging hook for distributed hangs.
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    # A worker must never outlive its spawner (head / node daemon) — a
    # SIGKILL'd parent gets no graceful-stop hook, so the kernel-level
    # death signal plus re-parent watchdog do the reaping (reference
    # capability: ``src/ray/util/subreaper.h`` orphan policy).
    if not os.environ.get("RT_NO_PDEATHSIG"):
        from ray_tpu_torch._private import reaper

        reaper.die_with_parent()
        reaper.start_orphan_watchdog()

    parser = argparse.ArgumentParser()
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--head-sock", default=None,
                        help="head UDS socket path (head-local workers)")
    parser.add_argument("--head-tcp", default=None,
                        help="head TCP address host:port (remote nodes)")
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--shm-domain", default=None)
    parser.add_argument("--tcp", action="store_true",
                        help="serve on TCP so other nodes can pull objects")
    args = parser.parse_args()

    # Import after arg parsing to keep failure messages clean.
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.ids import WorkerID
    from ray_tpu_torch.core.worker import CoreWorker

    if args.head_tcp:
        host, _, port = args.head_tcp.rpartition(":")
        head_address = (host, int(port))
    else:
        head_address = args.head_sock

    core = CoreWorker(
        session_dir=args.session_dir,
        head_sock=head_address,
        mode="worker",
        config=Config(),
        worker_id=WorkerID.from_hex(args.worker_id),
        listen_tcp=args.tcp,
        node_id=args.node_id,
        shm_domain=args.shm_domain,
    )
    core.start()

    # Register with the head: announce our serving address + home node.
    core.head_call("register_worker", {
        "worker_id": args.worker_id,
        "address": core.address,
        "node_id": args.node_id,
        "pid": os.getpid(),
    }, timeout=30)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    try:
        while not stop.is_set():
            stop.wait(1.0)
            core.flush_task_events()
    finally:
        core.shutdown()


if __name__ == "__main__":
    main()
