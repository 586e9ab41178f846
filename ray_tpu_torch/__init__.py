"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu: its core runtime,
serving decode path, training and libraries.

A package of its own beside ``ray_tpu`` (the JAX reference, which it never
imports). Its layout mirrors the reference so each module's counterpart is
found under the same name:

- :mod:`ray_tpu_torch.models.gpt` — GPT config, weights, forward core,
  remat policies, loss and ``make_train_step``;
- :mod:`ray_tpu_torch.models.gpt_decode` — flat and paged KV pools
  (prefill with prefix COW, k-step decode, int8 KV), greedy and seeded
  sampling, the speculative verify step, and KV export/import;
- :mod:`ray_tpu_torch._private.prng` — threefry2x32, bit-exact with
  ``jax.random`` (``PRNGKey``, ``split``, ``uniform``, ``categorical``,
  ``normal``), so ``init_params`` draws the reference's weights;
- :mod:`ray_tpu_torch.ops.paged_attention` — the paged decode-attention
  kernel, hand-written CUDA C++ for Hopper (``sm_90a``), plus its plain
  PyTorch version;
- :mod:`ray_tpu_torch.ops.flash_attention` — flash-attention forward and
  backward kernels (CUDA C++, ``sm_90a``) behind a differentiable
  ``flash_attention``, plus their plain PyTorch versions;
- :mod:`ray_tpu_torch.ops._build` — the ``nvcc`` build of every kernel
  source at first use;
- :mod:`ray_tpu_torch.serve.engine` — the continuous-batching
  :class:`~ray_tpu_torch.serve.engine.DecodeEngine` (paged or flat pool,
  temperature > 0 with per-request seeds, ``resume_from`` replay,
  speculative decoding, prefill/decode roles with KV handoff, driver
  supervision with epochs, drain, the config plane, and tensor
  parallelism over ``tp`` ranks);
- :mod:`ray_tpu_torch._private.tp` — tensor-parallel decode groups: rank
  0 the calling process, the other ranks follower processes running the
  same decode functions on their shards (gloo, or NCCL across cards);
- :mod:`ray_tpu_torch.serve.handoff` — handoff payloads, their SHA-256
  digest and leases (inline shipping only);
- :mod:`ray_tpu_torch.serve.draft` — the n-gram and model drafters;
- :mod:`ray_tpu_torch.data.llm` — offline batch inference over the
  engine: ``BatchInferencer``, its saturation policy, the exactly-once
  progress log and ``generate``;
- :mod:`ray_tpu_torch.serve.batching` — the request batcher ``@batch``
  (bucketed padding, streaming batches, continuous batching over the
  engine), with :mod:`ray_tpu_torch.serve.request` (the request context,
  deadlines and errors) and :mod:`ray_tpu_torch.util.tracing` (spans);
- :mod:`ray_tpu_torch.serve` — the serve front on the runtime:
  deployments and applications (``serve.deployment``, ``.bind``,
  ``serve.run``), handles and their router, the controller (reconcile,
  autoscaling, health, drain, a journal in the head's KV), replica
  actors (``ray_actor_options={"num_gpus": ...}`` claims the card), the
  HTTP proxy with chunked streaming and its gRPC ingress, and model
  multiplexing; :mod:`ray_tpu_torch.testing` holds its chaos helpers;
- :mod:`ray_tpu_torch.models.moe`, :mod:`ray_tpu_torch.models.resnet`,
  :mod:`ray_tpu_torch.parallel`, :mod:`ray_tpu_torch.collective`,
  :mod:`ray_tpu_torch.train` and :mod:`ray_tpu_torch.rllib` — MoE,
  ResNet, sharded training and RL.

The core runtime (``api.py``, ``core/worker.py``, ``_private/head.py``
and the object plane) schedules Python work across processes on one
node, as ``ray_tpu``'s does: ``import ray_tpu_torch as rt; rt.init();
@rt.remote ...`` gives tasks, actors, ``put``/``get``/``wait``, ``kill``,
placement groups, ``state``, ``timeline``, ``metrics_text`` and the
dashboard. ``GPU`` is the accelerator resource (``init(num_gpus=)``, the
``num_gpus`` option). Torch tensors travel through the shared-memory
store (``_private/serialization.py``: CUDA tensors arrive as CPU tensors,
and ``utils/device.device_put_shm`` stages them on the card); functions
and classes ship by value through the vendored
:mod:`ray_tpu_torch.cloudpickle`.

Multi-node clusters, the autoscaler (with GPU gangs) and the CLI
(``address="auto"``, ``serve deploy``) are ported, and so is Train
(``train/``: ``TorchTrainer`` on the runtime's actors). Not ported yet
(ROADMAP Queue 1): Data's ``Dataset``, Tune, ``dag.py``/``workflow/``
(the core's ``.bind()``) and the ``util`` helpers built on actors.

Importing ``ray_tpu_torch`` imports neither torch nor numpy: the runtime
stays light, and torch loads with the numeric subpackages or with the
first value that holds a tensor.

Entry points of the numeric subpackages run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card and without that argument they
raise.
"""
from .api import (  # noqa: F401
    ActorClass,
    ActorHandle,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    available_resources,
    cluster_resources,
    dashboard_url,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    list_actors,
    method,
    metrics_text,
    nodes,
    placement_group,
    put,
    remote,
    remove_placement_group,
    shutdown,
    state,
    timeline,
    wait,
)
from .core.worker import ObjectRef, ObjectRefGenerator  # noqa: F401
from . import exceptions  # noqa: F401

__version__ = "0.1.0"
