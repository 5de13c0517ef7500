"""Multi-process initialization (paddle_tpu/distributed/multihost.py).

Replaces the reference's cluster bring-up (trainer_id/num_gradient_servers
gflags and pserver discovery) with one call: ``initialize_multihost``
joins this process to a ``torch.distributed`` process group over a TCP
store at ``coordinator_address`` (rank 0 hosts the store), after which
``parallel.DataParallel`` sums gradients over the group's collectives.

The backend is chosen, not configured: gloo when the trainer's device (the
default device, ``init(use_tpu=...)``) is the CPU, or when the ranks'
devices on this host (each rank's local replicas, the
``PADDLE_TPU_TORCH_VIRTUAL_DEVICES`` a worker of ``--devices-per-process
k`` sets to k; one without it) outnumber its cards (NCCL refuses two
ranks on one device); NCCL otherwise, each rank on its own cards
(``cuda:<local rank * replicas>`` first). The ranks learn who shares
their host through the store; :func:`local_rank` is this rank's place
among them.
"""

import datetime
import os
import socket

import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger

STORE_TIMEOUT_SECS = 300
_local_rank = 0


def local_rank():
    """This rank's place among the ranks of its host (0 without a
    group)."""
    return _local_rank


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Join the process group from args/env/flags; returns True, or False
    (and does nothing) when single-host. Env parity with the JAX package,
    under the port's prefix: ``PADDLE_TPU_TORCH_NUM_HOSTS`` is the default
    process count, the ``trainer_id`` flag
    (``PADDLE_TPU_TORCH_TRAINER_ID``) the default rank."""
    global _local_rank
    from paddle_tpu_torch.parallel.mesh import virtual_device_count
    import torch.distributed as dist

    num_processes = num_processes or int(
        os.environ.get("PADDLE_TPU_TORCH_NUM_HOSTS", "1"))
    if num_processes <= 1 and coordinator_address is None:
        logger.info("single-host run; torch.distributed not initialized")
        return False
    enforce(coordinator_address is not None,
            "initialize_multihost(num_processes=%d) needs the "
            "coordinator_address (host:port of rank 0's store)",
            num_processes)
    process_id = (process_id if process_id is not None
                  else flags.get_flag("trainer_id"))
    device = resolve_device(None)  # raises for the card on a machine without
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(
                              seconds=STORE_TIMEOUT_SECS))
    me = socket.gethostname()
    store.set("paddle_tpu_torch/host/%d" % process_id, me)
    keys = ["paddle_tpu_torch/host/%d" % r for r in range(num_processes)]
    store.wait(keys)
    local = [r for r, k in enumerate(keys) if store.get(k).decode() == me]
    _local_rank = local.index(process_id)
    replicas = virtual_device_count() or 1
    first = _local_rank * replicas
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "gloo" if device.type == "cpu" \
        or len(local) * replicas > cards else "nccl"
    if device.type == "cuda":
        torch.cuda.set_device(first % cards)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    logger.info("torch.distributed initialized: process %d/%d over %s "
                "(%d rank(s) on this host, device %s)", process_id,
                num_processes, backend, len(local),
                "cpu" if device.type == "cpu"
                else "cuda:%d" % (first % cards))
    return True
