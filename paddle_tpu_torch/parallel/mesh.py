"""The device mesh and the data-parallel strategy (paddle_tpu/parallel/
mesh.py).

Replaces (reference): MultiGradientMachine's thread-ring data parallelism
and the pserver sync-SGD path. The JAX package pjits its train step over a
``jax.sharding.Mesh``; here the mesh is the ``torch.distributed`` process
group (distributed/multihost.py ``initialize_multihost``): one device per
rank, and the ``data`` axis has the size of the world. Without a process
group the mesh is this process alone (size 1) and nothing is exchanged.

:class:`DataParallel` is synchronous data parallelism over that axis:
every rank reads the same global batch and trains its contiguous share of
the rows (:meth:`DataParallel.share`; near-equal where the batch does not
divide, and a rank may hold none); the trainer (trainer.py) weights each
rank's mean cost by its share of the global rows and sums the gradients
with ``all_reduce``, so the update is the single-process one. Train-mode
batch norm reduces its moments over the whole global batch through
:func:`batch_reducer` while a step runs.
"""

import contextlib
import threading

import numpy as np
import torch

from paddle_tpu_torch.utils.error import enforce


def _group_up():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size():
    """Ranks of the process group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if _group_up() else 1


def rank():
    import torch.distributed as dist

    return dist.get_rank() if _group_up() else 0


def local_device_count():
    """The cards this process sees; 1 (the CPU) on a machine without."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_count():
    """The devices a mesh can span: the process group's ranks when one is
    up, else this process's own devices."""
    return world_size() if _group_up() else local_device_count()


class Mesh:
    """Named axes over the ranks of the process group (the port's
    ``jax.sharding.Mesh``): ``shape`` maps each axis name to its size,
    ``devices`` are the ranks. A context manager, as JAX's mesh is."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes)) if sizes else 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "Mesh(%s)" % self.shape


def build_mesh(axes=None, devices=None):
    """Build the mesh over the process group's ranks. ``axes``: dict
    name->size or a list of (name, size); -1 for one axis fills it with
    the remaining ranks. The axes' product must be the world size: one
    process drives one device, so a mesh cannot span fewer ranks than the
    group holds, nor more."""
    devices = list(range(world_size())) if devices is None else list(devices)
    if axes is None:
        axes = {"data": len(devices)}
    items = list(axes.items()) if isinstance(axes, dict) else list(axes)
    names = [k for k, _ in items]
    sizes = [int(v) for _, v in items]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    enforce(total == len(devices),
            "mesh %s needs %d devices, have %d", dict(zip(names, sizes)),
            total, len(devices))
    enforce(sorted(devices) == list(range(world_size())),
            "a mesh spans the ranks 0..%d of the process group, got %s",
            world_size() - 1, devices)
    return Mesh(devices, names, sizes)


def _slice_rows(value, lo, hi):
    """Rows [lo, hi) of one feed slot: a tensor, or every tensor of a
    SequenceBatch (packed ones too), NestedSequenceBatch or SparseRows
    (all of them lead with the row axis)."""
    from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                                PackedSequenceBatch,
                                                SequenceBatch)
    from paddle_tpu_torch.core.sparse import SparseRows

    if isinstance(value, PackedSequenceBatch):
        return PackedSequenceBatch(value.data[lo:hi], value.lengths[lo:hi],
                                   value.segments[lo:hi])
    if isinstance(value, SequenceBatch):
        return SequenceBatch(value.data[lo:hi], value.lengths[lo:hi])
    if isinstance(value, NestedSequenceBatch):
        return NestedSequenceBatch(value.data[lo:hi],
                                   value.outer_lengths[lo:hi],
                                   value.inner_lengths[lo:hi])
    if isinstance(value, SparseRows):
        return SparseRows(value.ids[lo:hi], None if value.vals is None
                          else value.vals[lo:hi], value.dim)
    return value[lo:hi]


def _slot_tensors(value):
    for attr in ("data", "ids"):
        if hasattr(value, attr):
            return [getattr(value, attr)]
    return [value]


# the reducer of the data-parallel step running on this thread, read by
# the train-mode batch norm (ops/conv.py); unset outside such a step
_step = threading.local()


def batch_reducer():
    """The all-reduce (sum over the ranks) that train-mode batch norm
    applies to its moments while a data-parallel step runs on this thread,
    or None."""
    return getattr(_step, "reducer", None)


class DataParallel:
    """Synchronous data parallelism over the mesh's ``axis``.

    Usage: ``SGD(..., parallelism=DataParallel(build_mesh()))`` in every
    rank of the process group. ``shard_optimizer_state=True`` (the JAX
    default, ZeRO-1 there) is accepted, and the optimizer slots stay whole
    on each rank: the update is the same, only the memory differs."""

    def __init__(self, mesh=None, axis="data", shard_optimizer_state=True):
        self.mesh = mesh or build_mesh()
        enforce(axis in self.mesh.shape, "mesh %s has no axis %r",
                self.mesh.shape, axis)
        enforce(self.mesh.shape[axis] == self.mesh.size,
                "DataParallel spans the whole mesh on %r; mesh %s has other "
                "axes wider than 1", axis, self.mesh.shape)
        self.axis = axis
        self.shard_optimizer_state = bool(shard_optimizer_state)
        self.world = self.mesh.size
        self.rank = rank()
        self._exchange = _group_up()

    @property
    def backend(self):
        """The process group's backend ("nccl", "gloo"), or None without
        a group (a world of one, nothing exchanged)."""
        import torch.distributed as dist

        return dist.get_backend() if self._exchange else None

    def check_device(self, device):
        """Refuse a trainer device the process group cannot exchange:
        NCCL needs the card."""
        enforce(not (self.backend == "nccl" and device.type != "cuda"),
                "DataParallel over NCCL needs the trainer on the card, got "
                "device %s", device)

    def capturable(self, device):
        """Whether a step's collectives can be captured in a CUDA graph on
        ``device``: NCCL's can; gloo stages CUDA tensors through the host,
        which a capture cannot hold."""
        return device.type != "cuda" or self.backend in (None, "nccl")

    # -- the batch ----------------------------------------------------------
    def share(self, rows):
        """(lo, hi): this rank's contiguous rows of a global batch of
        ``rows``; the first ``rows % world`` ranks take one more row."""
        base, extra = divmod(int(rows), self.world)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (1 if self.rank < extra else 0)

    @staticmethod
    def feed_rows(feed):
        """The global row count of a feed (the leading dim its slots
        share)."""
        counts = {int(_slot_tensors(v)[0].shape[0]) for v in feed.values()}
        enforce(len(counts) == 1, "feed slots disagree on the row count: %s",
                sorted(counts))
        return counts.pop()

    def shard_batch(self, feed, device=None):
        """This rank's share of a global feed, on ``device`` when given:
        ``(local feed, (rows, global rows))``. A rank whose share is empty
        gets the first row to run with weight 0 (its cost, gradients,
        evaluator statistics and batch-norm moments count nothing), so
        every rank runs the same collectives."""
        total = self.feed_rows(feed)
        lo, hi = self.share(total)
        rows = hi - lo
        if rows == 0:
            lo, hi = 0, 1
        local = {name: _slice_rows(v, lo, hi) for name, v in feed.items()}
        if device is not None:
            from paddle_tpu_torch.data.feeder import slot_to

            local = {name: slot_to(v, device) for name, v in local.items()}
        return local, (rows, total)

    # -- the exchange -------------------------------------------------------
    def broadcast_(self, tensors):
        """Overwrite ``tensors`` with rank 0's values, in place."""
        if not self._exchange:
            return
        import torch.distributed as dist

        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=0)

    def all_reduce_(self, tensor):
        """Sum ``tensor`` over the ranks, in place; returns it."""
        if self._exchange:
            import torch.distributed as dist

            dist.all_reduce(tensor)
        return tensor

    def gather(self, obj):
        """Every rank's ``obj`` (picklable), in rank order."""
        if not self._exchange:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    @contextlib.contextmanager
    def batch_scope(self, live):
        """While a step's forward and backward run: train-mode batch norm
        sums its moments over the ranks (this rank's times ``live``, 0 for
        a rank with an empty share)."""
        def reduce(t):
            if not live:
                t = t * 0.0
            return self.all_reduce_(t.contiguous())

        prev = batch_reducer()
        _step.reducer = reduce
        try:
            yield
        finally:
            _step.reducer = prev

    def __repr__(self):
        return "DataParallel(mesh=%s, axis=%r)" % (self.mesh.shape,
                                                   self.axis)


# -- the active mesh (use_mesh / current_mesh) --------------------------------
_current_mesh = None


def current_mesh():
    """The mesh use_mesh() made active, or None."""
    return _current_mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        with mesh:
            yield mesh
    finally:
        _current_mesh = prev
