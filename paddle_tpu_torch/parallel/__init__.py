"""Parallelism over the ranks of a torch.distributed process group
(paddle_tpu/parallel).

The JAX package replaces the reference's distribution stack
(MultiGradientMachine, ParallelNeuralNetwork, the C++ and Go pservers)
with XLA collectives inside one pjit-ed step; the port exchanges with
``torch.distributed`` collectives (NCCL where each rank has its own card,
gloo on the CPU and where ranks share a card) over the process groups of
a named mesh (``mesh``): synchronous data parallelism, Megatron tensor
parallelism (``tensor_parallel``), ring and Ulysses sequence parallelism
(``context_parallel``), the GPipe pipeline (``pipeline``) and the
vocab-sharded embedding (``sharded_embedding``). The JAX package's
``shard_map_compat`` (jax versions) and ``utils/cpu_mesh`` (jax
backends) have no counterpart: the process group takes their place.
"""

from paddle_tpu_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    NamedSharding,
    PartitionSpec,
    build_mesh,
    current_mesh,
    local_device_count,
    use_mesh,
)
from paddle_tpu_torch.parallel import sharded_embedding
from paddle_tpu_torch.parallel.context_parallel import (
    SequenceParallel,
    full_attention,
    ring_attention,
    ulysses_attention,
)
from paddle_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    megatron_dense_pair,
)
from paddle_tpu_torch.parallel.pipeline import (
    pipe_sharding,
    pipeline_apply,
    stack_stage_params,
)
