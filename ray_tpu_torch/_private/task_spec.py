"""Task/actor specifications exchanged between driver, head, and workers.

The port's copy of ``ray_tpu/_private/task_spec.py``.

Capability parity with the reference's ``TaskSpecification``
(reference: ``src/ray/common/task/task_spec.h``) and its scheduling-strategy
oneof (reference: ``src/ray/protobuf/common.proto:111-122``): default,
spread, node-affinity, and placement-group strategies are all expressible.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclass
class SchedulingStrategy:
    """Default hybrid policy unless a specific target is set."""

    # DEFAULT | SPREAD | NODE_AFFINITY | NODE_LABEL | PLACEMENT_GROUP
    kind: str = "DEFAULT"
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False
    # NODE_LABEL: nodes must carry every `hard_labels` pair; among those,
    # `soft_labels` matches are preferred (reference:
    # ``node_label_scheduling_policy.h`` + common.proto NodeLabel oneof).
    hard_labels: Optional[Dict[str, str]] = None
    soft_labels: Optional[Dict[str, str]] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    # Function payload: ("kv", function_key) once exported, or ("inline", bytes).
    function_ref: Tuple[str, Any]
    # Serialized call args: list of ("inline", frames) | ("ref", ObjectRef meta).
    args: List[Tuple[str, Any]] = field(default_factory=list)
    kwargs_keys: List[str] = field(default_factory=list)  # trailing args are kwargs
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_count: int = 0
    recovery_count: int = 0  # lineage re-executions consumed (owner-side)
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    # Actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seq_no: int = -1  # per-handle ordering for actor tasks
    # Named concurrency group this call runs in (None = method default
    # or the actor's default executor). Reference:
    # ``concurrency_group_manager.h``.
    concurrency_group: Optional[str] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    name: str = ""
    runtime_env: Optional[Dict[str, Any]] = None
    owner_address: Any = None  # socket address of the submitting process
    # Streaming generator support
    is_generator: bool = False
    # Propagated tracing context ({"trace_id","span_id"}) when the
    # submitter has tracing enabled (ray_tpu_torch/util/tracing.py).
    trace_ctx: Optional[Dict[str, str]] = None

    def return_object_ids(self) -> List[ObjectID]:
        # Cached: submission builds the caller-facing refs and reply
        # ingestion walks the same list — one construction, not two.
        ids = getattr(self, "_return_ids", None)
        if ids is None:
            ids = [ObjectID.for_task_return(self.task_id, i)
                   for i in range(self.num_returns)]
            object.__setattr__(self, "_return_ids", ids)
        return ids
