"""Device meshes, sharding rules and parallelism plans: the port of
``ray_tpu/parallel/``.

One process per rank, as PyTorch trains: :func:`initialize_multihost`
joins the process group, :func:`create_mesh` names its axes, and the
rules place every parameter (``LM_RULES``: ``fsdp``/``tp``-sharded
storage, ``dp`` x ``fsdp``-sharded batch). Pipeline (``pipeline.py``)
and multislice (``multislice.py``) are not ported yet.
"""
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    MeshConfig,
    create_mesh,
    initialize_multihost,
    local_chip_count,
    mesh_shape,
    single_device_mesh,
)
from .sharding import (  # noqa: F401
    BATCH_SPEC,
    DP_RULES,
    LM_RULES,
    PP_LM_RULES,
    PartitionSpec,
    Placement,
    batch_sharding,
    gather_tree,
    replicated,
    shard_tree,
    spec_for,
    tree_shardings,
)
