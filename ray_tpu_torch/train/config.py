"""Train configuration dataclasses: the port of ``ray_tpu/train/config.py``.

``ScalingConfig`` takes Ray's own ``TorchTrainer`` names for the
accelerator, ``use_gpu`` and ``gpus_per_worker``, where the reference has
``use_tpu`` and ``tpus_per_worker``; a worker's ``GPU`` becomes its
actor's ``num_gpus``. ``topology`` names a GPU gang (``"h100-16"``: 16
cards over 8-card hosts, ``_private/accelerators.py``), whose
``GPU-{gang}-head`` anchor bundle 0 claims.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one owns (``config.py:15``).

    One worker actor per card is PyTorch's unit (each a rank of the
    process group); ``gpus_per_worker`` below 1 packs several workers on
    one card. ``use_gpu`` plus ``topology`` reserve a whole gang."""

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 0        # cards each worker actor owns
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None    # e.g. "h100-16": gang resource name

    @property
    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return res

    def bundles(self) -> List[Dict[str, float]]:
        """One bundle per worker; with ``topology`` set, bundle 0 also
        claims the gang's ``GPU-{topology}-head`` anchor, so the whole
        gang lands on one set of hosts (``config.py:40-60``)."""
        bs = [dict(self.worker_resources) for _ in range(self.num_workers)]
        if self.topology:
            from .._private.accelerators import (head_resource_name,
                                                 parse_topology)

            _, cards = parse_topology(self.topology)
            if self.use_gpu:
                gang = self.num_workers * (self.gpus_per_worker or 1)
                if gang != cards:
                    raise ValueError(
                        f"topology {self.topology!r} has {cards} cards but "
                        f"the gang reserves {self.num_workers} x "
                        f"{self.gpus_per_worker or 1} = {gang:g}")
            bs[0][head_resource_name(self.topology)] = 1.0
        return bs

    @property
    def effective_placement_strategy(self) -> str:
        # A topology gang is one set of hosts: never spread it.
        if self.topology and self.placement_strategy in ("PACK", "SPREAD"):
            return "STRICT_PACK"
        return self.placement_strategy


@dataclasses.dataclass
class FailureConfig:
    """Restart-the-group fault tolerance (``config.py:66``): one failed
    rank breaks the process group, so recovery is a group restart from
    the latest checkpoint, never a per-worker retry."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
