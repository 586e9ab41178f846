"""WorkerGroup: N train-worker actors, optionally gang-placed. The port of
``ray_tpu/train/worker_group.py`` on the port's runtime.

Each worker actor hosts the user train loop in a background thread so
the actor stays responsive to result polls (``worker_group.py:17``). A
worker's ``GPU`` becomes its actor's ``num_gpus`` (the reference's
``TPU`` its ``num_tpus``). The runtime pins no card to a worker: the
backend tells each worker which card is its own (``RT_TRAIN_CARD``), and
the loop's thread makes it the current CUDA device before the loop runs.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from .. import api as rt

#: The card (index among the visible ones) a worker's loop runs on; set
#: by the backend, read by the loop's thread.
CARD_ENV = "RT_TRAIN_CARD"


class RayTrainWorker:
    """Actor body. One per train worker; runs the user loop in a thread."""

    def __init__(self, world_rank: int, world_size: int,
                 env: Optional[Dict[str, str]] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self._thread: Optional[threading.Thread] = None
        self._session = None
        for k, v in (env or {}).items():
            os.environ[k] = v

    def execute(self, fn, *args, **kwargs):
        """Run an arbitrary function in the actor (backend hooks)."""
        return fn(*args, **kwargs)

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       session_kwargs: Dict[str, Any]):
        from . import session as S

        self._session = S.init_session(
            world_rank=self.world_rank, world_size=self.world_size,
            wait_for_driver=True, **session_kwargs)
        sess = self._session

        def runner():
            try:
                _bind_card()
                train_fn(config) if _wants_arg(train_fn) else train_fn()
            except BaseException as e:  # noqa: BLE001 — forwarded to driver
                sess.error = e
            finally:
                sess.finished.set()

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="train-loop")
        self._thread.start()
        return True

    def poll(self, max_items: int = 16):
        """Drain queued reports; returns (items, finished, error_repr).
        Each report's ``train.report`` call returns once it is drained."""
        sess = self._session
        if sess is None:
            return [], True, None
        items = sess.take(max_items)
        err = None
        if sess.finished.is_set() and sess.error is not None:
            import traceback

            err = "".join(traceback.format_exception(sess.error))
        done = sess.finished.is_set() and sess.result_queue.empty()
        return items, done, err

    def shutdown_session(self):
        from . import session as S

        S.shutdown_session()
        return True


def _bind_card() -> None:
    """Make the worker's card the loop thread's current CUDA device (the
    current device is per thread)."""
    card = os.environ.get(CARD_ENV)
    if card is not None:
        import torch

        torch.cuda.set_device(int(card))


def _wants_arg(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len([p for p in sig.parameters.values()
                if p.default is p.empty
                and p.kind in (p.POSITIONAL_ONLY,
                               p.POSITIONAL_OR_KEYWORD)]) >= 1


def _node_id() -> str:
    from ..core.worker import CoreWorker

    return CoreWorker.current().node_id or ""


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_group=None,
                 env: Optional[Dict[str, str]] = None):
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker
        self.placement_group = placement_group
        self.env = env or {}
        self.workers: List[Any] = []
        #: each worker's node, and its index among the workers there
        self.nodes: List[str] = []
        self.local_ranks: List[int] = []

    def start(self, timeout: float = 60.0):
        opts: Dict[str, Any] = {
            "num_cpus": self.resources_per_worker.get("CPU", 1),
        }
        gpus = self.resources_per_worker.get("GPU", 0)
        if gpus:
            opts["num_gpus"] = gpus
        extra = {k: v for k, v in self.resources_per_worker.items()
                 if k not in ("CPU", "GPU")}
        if extra:
            opts["resources"] = extra
        cls = rt.remote(RayTrainWorker)
        for rank in range(self.num_workers):
            o = dict(opts)
            if self.placement_group is not None:
                o["scheduling_strategy"] = rt.PlacementGroupSchedulingStrategy(
                    self.placement_group, placement_group_bundle_index=rank)
            self.workers.append(
                cls.options(**o).remote(rank, self.num_workers,
                                        env=self.env))
        # Barrier: every actor constructed and reachable; their nodes
        # give each its local rank.
        nodes = rt.get([w.execute.remote(_node_id) for w in self.workers],
                       timeout=timeout)
        self.nodes = nodes
        self.local_ranks = [nodes[:r].count(n) for r, n in enumerate(nodes)]
        return self

    def execute(self, fn, *args, **kwargs) -> List[Any]:
        return rt.get(self.execute_async(fn, *args, **kwargs), timeout=120)

    def execute_async(self, fn, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn, *args, **kwargs):
        return rt.get(self.workers[rank].execute.remote(fn, *args, **kwargs),
                      timeout=120)

    def shutdown(self):
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
        self.workers = []

    def __len__(self):
        return len(self.workers)
