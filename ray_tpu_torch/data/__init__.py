"""Offline batch inference over the port's decode engine (the port of
``ray_tpu/data/llm.py`` and the block helpers it uses). ``Dataset``, its
executor and ``run_refs`` stand on the reference's runtime and are not
ported: :func:`~ray_tpu_torch.data.llm.generate` takes any iterable of
blocks."""
from .block import Block  # noqa: F401
from .llm import (  # noqa: F401
    BackpressurePolicy,
    BatchInferencer,
    EngineSaturationPolicy,
    ProgressLog,
    generate,
    resolve_engines,
)
