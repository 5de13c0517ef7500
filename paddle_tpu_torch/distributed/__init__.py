"""The distributed runtime of the port (paddle_tpu/distributed): the
coordinator and its client (task dispatch, membership leases, the save
election; ``client``, with the C++ service under ``coordinator/``),
elastic training (``elastic``), durable checkpoints (``checkpoint``),
multi-process initialization over torch.distributed (``multihost``) and
the local cluster launcher and its worker (``launcher``, ``worker``).
Gradient exchange is not here: parallel.DataParallel sums gradients with
torch.distributed collectives."""

from paddle_tpu_torch.distributed import checkpoint
from paddle_tpu_torch.distributed.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from paddle_tpu_torch.distributed.client import (CoordinatorClient,
                                                 spawn_coordinator)
from paddle_tpu_torch.distributed.multihost import initialize_multihost
