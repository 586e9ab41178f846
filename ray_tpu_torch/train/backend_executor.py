"""BackendExecutor: gang placement + backend rendezvous + training drive.
The port of ``ray_tpu/train/backend_executor.py``.

The reference's ``JaxBackend`` joins the workers into one
``jax.distributed`` job (``:38-86``); the port's :class:`TorchBackend`
joins them into one ``torch.distributed`` process group through the
port's ``parallel.initialize_multihost``, rank 0's host and a free port
of it as the rendezvous (``tcp://``). The process group's backend
follows ``_private/ranks.RankPool``'s rule: NCCL when every rank owns a
card of its own, gloo when ranks share a card or have none.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from .. import api as rt

from .config import ScalingConfig
from .worker_group import CARD_ENV, WorkerGroup


class Backend:
    """Per-framework hooks (reference ``train/backend.py`` Backend)."""

    def on_start(self, worker_group: WorkerGroup, backend_config) -> None:
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        pass


class TorchBackendConfig:
    """``multi_controller`` keeps the reference's switch
    (``JaxBackendConfig``): ``False`` (the default) leaves every worker a
    world of its own; ``True`` joins them into one process group, whose
    rendezvous is rank 0's ``coordinator_port`` (0: a free one)."""

    def __init__(self, multi_controller: bool = False,
                 coordinator_port: int = 0):
        self.multi_controller = multi_controller
        self.coordinator_port = coordinator_port

    def backend_cls(self):
        return TorchBackend


def _bind(env: Dict[str, str]) -> bool:
    """Worker side of :meth:`TorchBackend.on_start`: the torchrun
    variables, and a check that the card the worker was given exists."""
    os.environ.update(env)
    if CARD_ENV in env:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "use_gpu=True: this worker holds a GPU resource but sees "
                "no CUDA device")
        if int(env[CARD_ENV]) >= torch.cuda.device_count():
            raise RuntimeError(
                f"card {env[CARD_ENV]} is not among the "
                f"{torch.cuda.device_count()} visible")
    return True


def _host_port(fixed: int):
    import socket as s

    host = s.gethostbyname(s.gethostname())
    if fixed:
        return host, fixed
    # probe the free port on the host that will bind it (rank 0)
    sock = s.socket()
    sock.bind(("", 0))
    port = sock.getsockname()[1]
    sock.close()
    return host, port


def _init_dist(coord: str, n: int, rank: int, backend: str) -> bool:
    from ..parallel import initialize_multihost

    initialize_multihost(coordinator_address=coord, num_processes=n,
                         process_id=rank, backend=backend)
    return True


def _destroy_dist() -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class TorchBackend(Backend):
    """Process-group rendezvous (replaces the reference's
    ``initialize_multihost`` of ``jax.distributed``, ``:77``)."""

    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchBackendConfig) -> None:
        n = len(worker_group)
        gpus = worker_group.resources_per_worker.get("GPU", 0)
        local, nodes = worker_group.local_ranks, worker_group.nodes
        refs = []
        for rank, w in enumerate(worker_group.workers):
            env = {"RANK": str(rank), "WORLD_SIZE": str(n),
                   "LOCAL_RANK": str(local[rank]),
                   "LOCAL_WORLD_SIZE": str(nodes.count(nodes[rank]))}
            if gpus:
                # cards in the order the node's workers hold them: a
                # worker of g >= 1 cards starts at local_rank * g; workers
                # of a fraction share card floor(local_rank * g)
                env[CARD_ENV] = str(int(local[rank] * gpus))
            refs.append(w.execute.remote(_bind, env))
        rt.get(refs, timeout=120)
        if not backend_config.multi_controller:
            return
        host, port = worker_group.execute_single(
            0, _host_port, backend_config.coordinator_port)
        # NCCL when every rank owns at least a whole card, else gloo
        # (``ranks.py:71``: NCCL refuses two ranks on one card)
        backend = "nccl" if gpus >= 1 else "gloo"
        refs = [w.execute.remote(_init_dist, f"{host}:{port}", n, rank,
                                 backend)
                for rank, w in enumerate(worker_group.workers)]
        rt.get(refs, timeout=120)

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        rt.get([w.execute.remote(_destroy_dist)
                for w in worker_group.workers], timeout=30)


class TrainingFailedError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config, scaling_config: ScalingConfig,
                 max_failures: int = 0,
                 env: Optional[Dict[str, str]] = None):
        self.backend_config = backend_config
        self.scaling = scaling_config
        self.max_failures = max_failures
        self.env = env or {}
        self.backend: Backend = backend_config.backend_cls()()
        self.worker_group: Optional[WorkerGroup] = None
        self.placement_group = None
        self._num_failures = 0
        self._train_args: Optional[tuple] = None

    # ------------------------------------------------------------- start
    def start(self):
        if self.scaling.num_workers > 1 or self.scaling.use_gpu:
            self.placement_group = rt.placement_group(
                self.scaling.bundles(),
                strategy=self.scaling.effective_placement_strategy)
            self.placement_group.ready(timeout=60)
        self._start_group()

    def _start_group(self):
        self.worker_group = WorkerGroup(
            self.scaling.num_workers, self.scaling.worker_resources,
            placement_group=self.placement_group, env=self.env)
        self.worker_group.start()
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       session_kwargs_per_rank: List[Dict[str, Any]]):
        self.backend.on_training_start(self.worker_group,
                                       self.backend_config)
        self._train_args = (train_fn, config, session_kwargs_per_rank)
        refs = [
            w.start_training.remote(
                train_fn, config,
                dict(session_kwargs_per_rank[rank],
                     local_rank=self.worker_group.local_ranks[rank]))
            for rank, w in enumerate(self.worker_group.workers)
        ]
        rt.get(refs, timeout=120)

    # ------------------------------------------------------------- poll
    def poll(self) -> Dict[str, Any]:
        """One poll across workers → {"items": [...], "done": bool}, and
        ``"failed"`` (a message) when a worker's loop raised: its
        reports up to the error are in ``items``, and the caller takes
        them in before :meth:`handle_failure`. A worker actor's death
        restarts the group here (``"restarted"``), or raises
        TrainingFailedError once restarts are exhausted.
        """
        assert self.worker_group is not None
        try:
            outs = rt.get([w.poll.remote() for w in
                           self.worker_group.workers], timeout=60)
        except Exception as e:  # actor death → group restart
            self.handle_failure(f"worker actor failure: {e!r}")
            return {"items": [], "done": False, "restarted": True}
        items: List[dict] = []
        done = True
        failed = None
        for rank, (reports, finished, err) in enumerate(outs):
            items.extend(reports)
            if err and failed is None:
                failed = f"rank {rank} train loop error:\n{err}"
            done = done and finished
        if failed is not None:
            return {"items": items, "done": False, "failed": failed}
        return {"items": items, "done": done}

    def handle_failure(self, msg: str):
        """Restart the group, or raise TrainingFailedError once
        ``max_failures`` restarts are spent."""
        self._num_failures += 1
        if self._num_failures > self.max_failures:
            self.shutdown()
            raise TrainingFailedError(
                f"{msg}\n(failure {self._num_failures} > "
                f"max_failures={self.max_failures})")
        self._restart()

    def set_latest_checkpoint(self, checkpoint) -> None:
        """Patch resume-checkpoint into session kwargs for future restarts."""
        if self._train_args is not None:
            for kw in self._train_args[2]:
                kw["latest_checkpoint"] = checkpoint

    def _restart(self):
        """Tear down the gang and rebuild; the loop resumes from the
        latest checkpoint (``backend_executor.py:170-183``). The old
        workers are killed, not asked to leave their process group: a
        survivor may sit in a collective with the dead rank."""
        assert self._train_args is not None
        if self.worker_group:
            self.worker_group.shutdown()
        self._start_group()
        train_fn, config, session_kwargs = self._train_args
        for kw in session_kwargs:
            kw["incarnation"] = kw.get("incarnation", 0) + 1
        self.start_training(train_fn, config, session_kwargs)

    def shutdown(self):
        if self.worker_group:
            try:
                self.backend.on_shutdown(self.worker_group)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self.placement_group is not None:
            try:
                rt.remove_placement_group(self.placement_group)
            except Exception:
                pass
            self.placement_group = None
