"""Trainers: DataParallelTrainer / TorchTrainer + TrainingIterator + Result.
The port of ``ray_tpu/train/trainer.py``, with :class:`TorchTrainer` in
the place of ``JaxTrainer`` (``:253``).

Reference: ``python/ray/train/base_trainer.py:111`` (``fit:567``),
``data_parallel_trainer.py:25`` (``training_loop:428``), ``trainer.py``
(``TrainingIterator:31``). ``fit()`` runs the loop inline. The
reference's ``as_trainable`` wraps a trainer as a Tune trial; Tune is not
ported yet (ROADMAP Queue 1 item 5), so the port's raises.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from .backend_executor import (BackendExecutor, TorchBackendConfig,
                               TrainingFailedError)
from .checkpoint import Checkpoint, CheckpointManager
from .config import (CheckpointConfig, FailureConfig, RunConfig,
                     ScalingConfig)


class Result:
    """Outcome of a run (reference ``ray.train.Result``)."""

    def __init__(self, metrics: Dict[str, Any],
                 checkpoint: Optional[Checkpoint],
                 best_checkpoint: Optional[Checkpoint],
                 metrics_history: List[Dict[str, Any]],
                 error: Optional[BaseException] = None,
                 path: Optional[str] = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.best_checkpoint = best_checkpoint
        self.metrics_history = metrics_history
        self.error = error
        self.path = path

    def __repr__(self):
        return (f"Result(metrics={self.metrics}, "
                f"checkpoint={self.checkpoint})")


class TrainingIterator:
    """Drives the poll loop; yields per-report aggregated metrics."""

    def __init__(self, executor: BackendExecutor,
                 checkpoint_manager: CheckpointManager,
                 poll_interval: float = 0.05):
        self.executor = executor
        self.ckpt_manager = checkpoint_manager
        self.poll_interval = poll_interval

    def __iter__(self):
        pending: Dict[int, Dict[int, dict]] = {}
        next_idx = 0
        world = self.executor.scaling.num_workers
        while True:
            out = self.executor.poll()
            if out.get("restarted"):
                # Fresh group resumed from latest checkpoint; reports
                # restart from idx 0 on the new incarnation.
                pending.clear()
                next_idx = 0
                continue
            for item in out["items"]:
                pending.setdefault(item["idx"], {})[item["rank"]] = item
            # emit every fully-gathered report index in order
            while next_idx in pending and \
                    len(pending[next_idx]) == world:
                by_rank = pending.pop(next_idx)
                next_idx += 1
                yield self._aggregate(by_rank)
            if out.get("failed"):
                # The reports before the error are in (their checkpoints
                # registered): restart, resuming from the latest one.
                self.executor.handle_failure(out["failed"])
                pending.clear()
                next_idx = 0
                continue
            if out["done"]:
                # Ranks may report unequal counts (e.g. rank-0-only
                # reporting); flush partial indices in order rather than
                # spinning forever on a barrier nobody will complete.
                for idx in sorted(pending):
                    yield self._aggregate(pending[idx])
                return
            time.sleep(self.poll_interval)

    def _aggregate(self, by_rank: Dict[int, dict]) -> Dict[str, Any]:
        """Rank-0's metrics win (reference semantics); register rank-0's
        checkpoint. Non-lead ranks GC their own checkpoints worker-side."""
        lead = by_rank.get(min(by_rank))
        metrics = dict(lead["metrics"])
        meta = lead.get("checkpoint")
        # only rank 0's checkpoints are registrable: other ranks GC their
        # own dirs (keep-2), so a flushed partial index led by rank>0
        # could hand the manager an already-deleted path
        if min(by_rank) != 0:
            meta = None
        if meta:
            ckpt = self.ckpt_manager.register(Checkpoint(meta["path"]),
                                              metrics)
            self.executor.set_latest_checkpoint(ckpt)
            metrics["checkpoint_path"] = ckpt.path
        return metrics


class BaseTrainer:
    _handles_tune = False

    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self) -> Callable:
        """The reference's function-trainable wrapper for Tune
        (``trainer.py:113-126``); Tune is not ported yet."""
        raise NotImplementedError(
            "as_trainable needs ray_tpu_torch.tune, which is not ported "
            "yet (ROADMAP Queue 1 item 5)")

    def _with_overrides(self, config: Dict[str, Any]) -> "BaseTrainer":
        return self


class DataParallelTrainer(BaseTrainer):
    """Spawns N workers running ``train_loop_per_worker``
    (reference ``data_parallel_trainer.py:25``)."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config=None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or TorchBackendConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    # -- storage ----------------------------------------------------------
    def _experiment_dir(self) -> str:
        from .storage import get_filesystem, is_uri

        name = self.run_config.name or \
            f"{type(self).__name__}_{uuid.uuid4().hex[:8]}"
        base = self.run_config.resolved_storage_path()
        if is_uri(base):
            fs, _ = get_filesystem(base)
            d = fs.join(base, name)
            fs.makedirs(d)
        else:
            d = os.path.join(base, name)
            os.makedirs(d, exist_ok=True)
        return d

    def fit(self) -> Result:
        from .. import api as rt

        if not rt.is_initialized():
            rt.init(ignore_reinit_error=True)

        exp_dir = self._experiment_dir()
        cc: CheckpointConfig = self.run_config.checkpoint_config
        ckpt_manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order)

        executor = BackendExecutor(
            self.backend_config, self.scaling_config,
            max_failures=self.run_config.failure_config.max_failures)
        try:
            executor.start()
        except BaseException:
            # a gang that cannot start (no card, no placement) leaves no
            # worker or placement group behind
            executor.shutdown()
            raise

        # dataset shards: anything with streaming_split is split; plain
        # iterables pass through whole.
        shards_per_rank = self._split_datasets()

        session_kwargs = []
        for rank in range(self.scaling_config.num_workers):
            session_kwargs.append({
                "experiment_name": self.run_config.name or "train",
                # final checkpoint home — workers write here directly and
                # the manager adopts paths in place (no driver-side moves)
                "storage_dir": os.path.join(exp_dir, "checkpoints"),
                "latest_checkpoint": self.resume_from_checkpoint,
                "dataset_shards": shards_per_rank[rank],
            })

        executor.start_training(self.train_loop_per_worker,
                                self.train_loop_config, session_kwargs)

        history: List[Dict[str, Any]] = []
        error: Optional[BaseException] = None
        try:
            for metrics in TrainingIterator(executor, ckpt_manager):
                history.append(metrics)
        except TrainingFailedError as e:
            error = e
        finally:
            executor.shutdown()

        return Result(
            metrics=history[-1] if history else {},
            checkpoint=ckpt_manager.latest_checkpoint,
            best_checkpoint=ckpt_manager.best_checkpoint,
            metrics_history=history,
            error=error,
            path=exp_dir,
        )

    def _split_datasets(self) -> List[Dict[str, Any]]:
        n = self.scaling_config.num_workers
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            split = getattr(ds, "streaming_split", None)
            if callable(split):
                # equal=True: every worker sees the same number of rows —
                # required for SPMD steps (reference DataConfig default).
                for rank, it in enumerate(split(n, equal=True)):
                    shards[rank][name] = it
            else:
                for rank in range(n):
                    shards[rank][name] = ds
        return shards

    def _with_overrides(self, config: Dict[str, Any]) -> "BaseTrainer":
        merged = dict(self.train_loop_config)
        merged.update(config.get("train_loop_config", config))
        return type(self)(
            self.train_loop_per_worker,
            train_loop_config=merged,
            backend_config=self.backend_config,
            scaling_config=self.scaling_config,
            run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint,
        )


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch backend defaults (Ray's own
    ``torch/torch_trainer.py:11``; the reference's ``JaxTrainer``)."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchBackendConfig] = None,
                 backend_config=None, **kwargs):
        super().__init__(
            train_loop_per_worker,
            backend_config=torch_config or backend_config
            or TorchBackendConfig(),
            **kwargs)
