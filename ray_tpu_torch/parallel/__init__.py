"""Device meshes, sharding rules and parallelism plans: the port of
``ray_tpu/parallel/``.

One process per rank, as PyTorch trains: :func:`initialize_multihost`
joins the process group, :func:`create_mesh` names its axes, and the
rules place every parameter (``LM_RULES``: ``fsdp``/``tp``/``ep``-sharded
storage, ``dp`` x ``fsdp``-sharded batch; ``PP_LM_RULES``: each pipeline
stage's layers). :func:`pipeline_apply` runs the GPipe schedule over
``pp``; :func:`dcn_allreduce_tree` and :func:`run_multislice_dryrun`
compose a mesh inside each slice with a host group across slices.
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
from .multislice import (  # noqa: F401
    dcn_allreduce_tree,
    run_multislice_dryrun,
)
from .pipeline import pipeline_apply  # noqa: F401
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
