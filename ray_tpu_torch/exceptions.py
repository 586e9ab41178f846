"""Public exception types (capability parity with ray.exceptions).

The port's copy of ``ray_tpu/exceptions.py``.
"""
from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception on a remote worker.

    Carries the remote traceback string; re-raised at ``get()`` like the
    reference's RayTaskError (reference: ``python/ray/exceptions.py``).
    """

    def __init__(self, cause_type: str, message: str, remote_traceback: str):
        self.cause_type = cause_type
        self.message = message
        self.remote_traceback = remote_traceback
        super().__init__(f"{cause_type}: {message}\n\n"
                         f"Remote traceback:\n{remote_traceback}")

    def __reduce__(self):
        return (TaskError,
                (self.cause_type, self.message, self.remote_traceback))


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """A method call was made on a dead actor."""

    def __init__(self, cause: str = ""):
        self.cause = cause
        super().__init__(f"actor is dead: {cause}")

    def __reduce__(self):
        return (ActorDiedError, (self.cause,))


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get() timed out."""


class ObjectLostError(RayTpuError):
    """An object could not be retrieved from any location."""


class PlacementGroupError(RayTpuError):
    """Placement group creation or use failed."""
