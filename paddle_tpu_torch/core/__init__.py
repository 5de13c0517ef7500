"""Core types: places and the device choice, dtype policy, DDim,
sequence batches, sparse rows (paddle_tpu/core; the JAX package's
re-exports, and the port's own ``resolve_device`` and ``SparseRows``)."""

from paddle_tpu_torch.core import dtype, place, sequence, sparse
from paddle_tpu_torch.core.ddim import DDim, make_ddim
from paddle_tpu_torch.core.place import (CPUPlace, Place, TPUPlace,
                                         default_place, resolve_device,
                                         set_default_place)
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.core.sparse import SparseRows
