"""The distributed runtime of the port (paddle_tpu/distributed): only the
durable checkpoint (``checkpoint``) is here. The elastic coordinator
client, data parallelism and multi-host initialization come with a later
part of the port: reading one raises AttributeError ("not ported yet")
until then."""

from paddle_tpu_torch.distributed import checkpoint
from paddle_tpu_torch.distributed.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

_NOT_PORTED = ("CoordinatorClient", "spawn_coordinator",
               "initialize_multihost")


def __getattr__(name):
    # AttributeError, so that hasattr() answers False
    if name in _NOT_PORTED:
        raise AttributeError(
            "paddle_tpu_torch.distributed.%s is not ported yet" % name)
    raise AttributeError("module 'paddle_tpu_torch.distributed' has no "
                         "attribute %r" % name)
