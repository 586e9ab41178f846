"""Collective communication (the port of ``ray_tpu/collective/``):
groups over ``torch.distributed`` process groups, NCCL or gloo."""
from .collective import (  # noqa: F401
    BaseGroup,
    MeshGroup,
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
