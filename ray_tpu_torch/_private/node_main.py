"""Node daemon entry point (reference capability: ``ray start`` joining an
existing cluster — ``python/ray/scripts/scripts.py`` ``ray start
--address=...``).

The port's copy of ``ray_tpu/_private/node_main.py``.

Run on each host of a multi-node cluster:

    python -m ray_tpu_torch._private.node_main \
        --head 10.0.0.1:6379 --num-cpus 8 --num-gpus 4
"""
from __future__ import annotations

import argparse
import asyncio
import json
import signal


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", required=True,
                        help="head TCP address host:port")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--num-cpus", type=float, default=1.0)
    parser.add_argument("--num-gpus", type=float, default=0.0)
    parser.add_argument("--resources", default="{}",
                        help="extra resources as JSON")
    parser.add_argument("--shm-domain", default=None)
    parser.add_argument("--private-shm-domain", action="store_true",
                        help="this daemon's shm domain is exclusively "
                             "its own: sweep leftover segments on stop "
                             "(cluster_utils sets this for its "
                             "synthetic per-node domains)")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--die-with-parent", action="store_true",
                        help="SIGKILL this daemon when its spawner dies "
                             "(test harnesses; operators omit it)")
    args = parser.parse_args(argv)

    from ray_tpu_torch._private import reaper
    from ray_tpu_torch._private.node import NodeService

    # Workers we spawn re-parent to us (not init) if an intermediate
    # shell dies, so our stop() can always reach them.
    reaper.become_subreaper()
    if args.die_with_parent:
        reaper.die_with_parent()
        reaper.start_orphan_watchdog()

    host, _, port = args.head.rpartition(":")
    resources = {"CPU": args.num_cpus}
    if args.num_gpus:
        resources["GPU"] = args.num_gpus
    resources.update(json.loads(args.resources))

    async def run():
        node = NodeService(
            head_address=(host, int(port)),
            session_dir=args.session_dir,
            resources=resources,
            shm_domain=args.shm_domain,
            private_domain=args.private_shm_domain,
            labels=json.loads(args.labels),
        )
        await node.start()
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        loop.add_signal_handler(signal.SIGINT, stop.set)
        waiter = loop.create_task(node.run_forever())
        stopper = loop.create_task(stop.wait())
        await asyncio.wait([waiter, stopper],
                           return_when=asyncio.FIRST_COMPLETED)
        await node.stop()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    main()
