"""Training library: the port of ``ray_tpu/train/`` on the port's runtime.

``TorchTrainer`` runs a training loop in worker actors
(``worker_group.py``), joined into one ``torch.distributed`` process
group when asked (``backend_executor.py``), with group restart from the
latest checkpoint on a failure; checkpoints (``checkpoint.py``) go to a
directory or a storage URI (``storage.py``), and the loop reports
through the session (``session.py``).
"""
from .checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .backend_executor import (  # noqa: F401
    Backend,
    BackendExecutor,
    TorchBackend,
    TorchBackendConfig,
    TrainingFailedError,
)
from .session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from .trainer import (  # noqa: F401
    BaseTrainer,
    DataParallelTrainer,
    Result,
    TorchTrainer,
    TrainingIterator,
)
from .worker_group import RayTrainWorker, WorkerGroup  # noqa: F401

from .._private.usage_stats import record_feature as _rf  # noqa: E402
_rf("train")
del _rf
