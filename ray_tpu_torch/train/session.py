"""In-worker training session: report / get_checkpoint /
get_dataset_shard / get_context, the port of ``ray_tpu/train/session.py``.

The reference's trainer, worker group and backend executor launch the
loop on the runtime's actors and are not ported; a caller that runs one
process per rank (``torchrun``, or the port's rank pool) starts a session
with :func:`init_session` and reads the reports from its queue.
``jax.process_count()`` becomes the process group's world size.
Storage is a local (or mounted) directory.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint, _local

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class _TrainSession:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0,
                 experiment_name: str = "train",
                 storage_dir: Optional[str] = None,
                 latest_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 trial_info: Optional[Dict[str, Any]] = None,
                 incarnation: int = 0):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.experiment_name = experiment_name
        self.storage_dir = None if storage_dir is None \
            else _local(storage_dir)
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.trial_info = trial_info or {}
        self.result_queue: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self._report_idx = 0
        self._own_ckpts: list = []
        self._sharded_idx = 0
        self.incarnation = incarnation

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        """Queue ``metrics`` (and the checkpoint's final path) for the
        driver (``session.py:68``). A checkpoint is moved into
        ``storage_dir`` under a rank- and incarnation-stamped name, unless
        it is a collective sharded directory already inside it (one
        checkpoint that every rank wrote into)."""
        payload: Dict[str, Any] = {
            "metrics": dict(metrics),
            "idx": self._report_idx,
            "rank": self.world_rank,
        }
        if checkpoint is not None:
            in_place = False
            if _process_count() > 1 and self.storage_dir:
                in_place = os.path.commonpath(
                    [checkpoint.path, self.storage_dir]) == self.storage_dir
            if not in_place and self.storage_dir:
                # incarnation in the name: a restarted group's indices
                # begin at 0 again and must not overwrite tracked dirs
                name = (f"checkpoint_rank{self.world_rank}_"
                        f"i{self.incarnation}_{self._report_idx:06d}")
                os.makedirs(self.storage_dir, exist_ok=True)
                dst = os.path.join(self.storage_dir, name)
                if checkpoint.path != dst:
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    shutil.move(checkpoint.path, dst)
                checkpoint = Checkpoint(dst)
            payload["checkpoint"] = checkpoint.to_dict()
            self.latest_checkpoint = checkpoint
            # Non-lead ranks own their GC (the driver tracks rank 0's):
            # keep the two most recent; a collective sharded dir is the
            # gang's one restore point and is never theirs to delete.
            if self.world_rank != 0 and self.storage_dir and not in_place:
                self._own_ckpts.append(checkpoint.path)
                while len(self._own_ckpts) > 2:
                    shutil.rmtree(self._own_ckpts.pop(0), ignore_errors=True)
        self._report_idx += 1
        self.result_queue.put(payload)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def next_sharded_checkpoint_path(self) -> str:
        """The directory of the next sharded save (``session.py:134``):
        with several processes every rank derives the same name (one
        collective checkpoint, many shard writers); a lone process's name
        carries its rank."""
        rank = "" if _process_count() > 1 else f"rank{self.world_rank}_"
        path = os.path.join(
            self.storage_dir,
            f"sharded_{rank}i{self.incarnation}_{self._sharded_idx:06d}")
        self._sharded_idx += 1
        return path

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}; available: "
                           f"{list(self.dataset_shards)}")
        return shard


def init_session(**kwargs) -> _TrainSession:
    global _session
    with _session_lock:
        _session = _TrainSession(**kwargs)
        return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session():
    global _session
    with _session_lock:
        _session = None


def _require_session() -> _TrainSession:
    s = get_session()
    if s is None:
        raise RuntimeError(
            "No train session active — this API must be called inside a "
            "training loop that started one (init_session)")
    return s


# ------------------------------------------------------------ public API
def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _require_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return _require_session().get_dataset_shard(name)


class TrainContext:
    """The reference's ``get_context()`` surface."""

    def get_world_rank(self) -> int:
        return _require_session().world_rank

    def get_world_size(self) -> int:
        return _require_session().world_size

    def get_local_rank(self) -> int:
        return _require_session().local_rank

    def get_experiment_name(self) -> str:
        return _require_session().experiment_name

    def get_trial_info(self) -> Dict[str, Any]:
        return _require_session().trial_info


def get_context() -> TrainContext:
    return TrainContext()
