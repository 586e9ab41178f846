"""ray_tpu_torch.serve: the serving path of the port. The request
batcher (``@batch``, bucketed padding, continuous batching over the
engine), the continuous-batching :class:`DecodeEngine`, its drafters and
the request vocabulary. The reference's deployments, handles, proxy and
controller stand on its runtime and are not ported."""
from .batching import batch, default_buckets, pad_to_bucket
from .draft import Drafter, ModelDrafter, NGramDrafter
from .engine import DecodeEngine, EngineRestartError, EngineShutdownError
from .request import (BackPressureError, ReplicaDrainingError,
                      ReplicaOverloadedError, Request,
                      RequestDeadlineExceeded, Response,
                      get_request_deadline)

__all__ = [
    "BackPressureError", "DecodeEngine", "Drafter", "EngineRestartError",
    "EngineShutdownError", "ModelDrafter", "NGramDrafter",
    "ReplicaDrainingError", "ReplicaOverloadedError", "Request",
    "RequestDeadlineExceeded", "Response", "batch", "default_buckets",
    "get_request_deadline", "pad_to_bucket",
]
