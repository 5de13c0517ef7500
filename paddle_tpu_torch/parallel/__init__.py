"""Parallelism over the ranks of a torch.distributed process group
(paddle_tpu/parallel).

The JAX package replaces the reference's distribution stack
(MultiGradientMachine, the C++ and Go pservers) with XLA collectives
inside one pjit-ed step; the port exchanges gradients with
``torch.distributed`` collectives (NCCL where each rank has its own card,
gloo on the CPU and where ranks share a card). Ported: the mesh and
synchronous data parallelism (``mesh``). Tensor, sequence and pipeline
parallelism and the sharded embedding come with a later part of the port.
"""

from paddle_tpu_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    build_mesh,
    current_mesh,
    local_device_count,
    use_mesh,
)
