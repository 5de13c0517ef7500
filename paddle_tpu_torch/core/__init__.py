"""Core types: dtype policy, device choice, sequence batches, sparse
rows."""

from paddle_tpu_torch.core import dtype, place, sequence, sparse
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.sparse import SparseRows
