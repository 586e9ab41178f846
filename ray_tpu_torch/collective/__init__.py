"""Collective communication (the port of ``ray_tpu/collective/``):
groups over ``torch.distributed`` process groups, NCCL or gloo, and the
store group over the runtime's KV and object store."""
from .collective import (  # noqa: F401
    BaseGroup,
    MeshGroup,
    StoreGroup,
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    destroy_collective_group,
    get_group,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
