"""Training library (the port of ``ray_tpu/train/``): checkpoints and the
in-worker session. The trainer, worker group and backend executor stand
on the reference's runtime (actors) and are not ported."""
from .checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from .session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
