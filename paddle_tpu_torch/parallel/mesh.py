"""The device mesh, the sharding descriptor and the data-parallel strategy
(paddle_tpu/parallel/mesh.py).

Replaces (reference): MultiGradientMachine's thread-ring data parallelism
and the pserver sync-SGD path. The JAX package pjits its train step over a
``jax.sharding.Mesh``; here the mesh is the ``torch.distributed`` process
group (distributed/multihost.py ``initialize_multihost``): one device per
rank, the ranks laid out row-major over the named axes, one process group
per slice of each axis (:meth:`Mesh.axis`). Without a process group the
mesh is this process alone (size 1) and nothing is exchanged.
:class:`NamedSharding` (mesh plus :class:`PartitionSpec`) says which
block of a global tensor a rank holds.

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


class Axis:
    """One axis of a mesh as this rank sees it: its ``name``, ``size``,
    this rank's ``index`` on it, the global ``ranks`` of the slice of the
    mesh this rank shares with the other members of the axis (every other
    coordinate equal), in axis order, and the process ``group`` over
    them (None where nothing is exchanged: a size of 1, or no process
    group)."""

    __slots__ = ("name", "size", "index", "ranks", "group")

    def __init__(self, name, size, index, ranks, group):
        self.name, self.size, self.index = name, int(size), int(index)
        self.ranks, self.group = list(ranks), group

    def __repr__(self):
        return "Axis(%r, size=%d, index=%d)" % (self.name, self.size,
                                                self.index)


class Mesh:
    """Named axes over the ranks of the process group (the port's
    ``jax.sharding.Mesh``): ``shape`` maps each axis name to its size,
    ``devices`` are the ranks, laid out row-major over the axes as
    ``np.array(devices).reshape(sizes)`` lays out JAX's devices. Each
    axis has one process group per slice (:meth:`axis`); a collective
    over an axis runs over this rank's slice only. A context manager, as
    JAX's mesh is."""

    def __init__(self, devices, axis_names, sizes, groups=None, rank=0):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes)) if sizes else 1
        coords = (np.unravel_index(self.devices.index(int(rank)), sizes)
                  if sizes else ())
        layout = np.array(self.devices).reshape(sizes) if sizes else None
        self._axes = {}
        for pos, name in enumerate(self.axis_names):
            where = list(coords)
            where[pos] = slice(None)
            ranks = [int(r) for r in layout[tuple(where)]]
            self._axes[name] = Axis(name, sizes[pos], coords[pos], ranks,
                                    (groups or {}).get(name))

    def axis(self, name):
        """This rank's :class:`Axis` ``name``: its index there, the axis
        size and the process group of its slice."""
        enforce(name in self._axes, "mesh %s has no axis %r", self.shape,
                name)
        return self._axes[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "Mesh(%s)" % self.shape


def _axis_groups(devices, names, sizes):
    """{axis name: this rank's process group along it}: one
    ``torch.distributed.new_group`` per slice of every axis wider than 1
    (every rank creates every group, in the same order, as new_group
    requires), the default group where the axis spans the whole world."""
    import torch.distributed as dist

    if not _group_up() or world_size() == 1:
        return {}
    me = rank()
    layout = np.array(devices).reshape(sizes)
    groups = {}
    for pos, name in enumerate(names):
        if sizes[pos] == 1:
            continue
        if sizes[pos] == world_size():
            groups[name] = dist.group.WORLD
            continue
        slices = np.moveaxis(layout, pos, -1).reshape(-1, sizes[pos])
        for ranks in slices:
            group = dist.new_group([int(r) for r in ranks])
            if me in ranks:
                groups[name] = group
    return groups


def build_mesh(axes=None, devices=None):
    """Build the mesh over the process group's ranks. ``axes``: dict
    name->size or a list of (name, size); -1 for one axis fills it with
    the remaining ranks. The axes' product must be the world size: one
    process drives one device, so a mesh cannot span fewer ranks than the
    group holds, nor more. Every rank of the group must call it with the
    same axes (it creates the axes' process groups)."""
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
    return Mesh(devices, names, sizes,
                groups=_axis_groups(devices, names, sizes), rank=rank())


class PartitionSpec(tuple):
    """One entry per dimension: the mesh axis that dimension is split
    over, or None (replicated); JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class NamedSharding:
    """The port's sharding descriptor: a mesh and a :class:`PartitionSpec`
    (JAX's ``NamedSharding``). A rank holds the block of a global tensor
    at its coordinates: :meth:`shard` cuts it, :meth:`gather` puts the
    global tensor back together from every rank's block (a collective:
    every rank of the named axes calls it)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def _dims(self, ndim):
        enforce(len(self.spec) <= ndim, "sharding %s has more entries than "
                "the tensor's %d dimensions", self.spec, ndim)
        return [(d, self.mesh.axis(a)) for d, a in enumerate(self.spec)
                if a is not None]

    def local_shape(self, shape):
        shape = list(shape)
        for d, ax in self._dims(len(shape)):
            enforce(shape[d] % ax.size == 0, "axis %s of size %d must "
                    "divide dimension %d of %s", ax.name, ax.size, d,
                    tuple(shape))
            shape[d] //= ax.size
        return tuple(shape)

    def shard(self, tensor):
        """This rank's block of the global ``tensor`` (a view where it
        can be one)."""
        self.local_shape(tensor.shape)
        for d, ax in self._dims(tensor.dim()):
            tensor = tensor.chunk(ax.size, d)[ax.index]
        return tensor

    def block(self, tensor, shape, grad=False):
        """This rank's block of ``tensor``, the one place that tells a
        global tensor of ``shape`` from a block of it: a global tensor is
        cut (a copy, so the global one can be freed; with ``grad`` a
        differentiable cut whose gradient gathers back whole), a block
        passes through as it is."""
        shape = tuple(int(s) for s in shape)
        local = self.local_shape(shape)
        if tuple(tensor.shape) == local:
            return tensor
        enforce(tuple(tensor.shape) == shape, "a tensor of shape %s is "
                "neither the global %s nor this rank's block %s of %r",
                tuple(tensor.shape), shape, local, self)
        if not grad:
            return self.shard(tensor).clone()
        from paddle_tpu_torch.parallel.collectives import split

        for d, ax in self._dims(len(shape)):
            tensor = split(tensor, ax, d)
        return tensor

    def leading(self, ndim):
        """The sharding of the spec's first ``ndim`` dimensions (a per-row
        optimizer slot of a row-sharded table)."""
        return NamedSharding(self.mesh, P(*tuple(self.spec)[:ndim]))

    def gather(self, block):
        """The global tensor from every rank's ``block`` (no gradient)."""
        import torch.distributed as dist

        out = block.detach()
        for d, ax in self._dims(block.dim()):
            if ax.group is None:
                continue
            parts = [torch.empty_like(out) for _ in range(ax.size)]
            dist.all_gather(parts, out.contiguous(), group=ax.group)
            out = torch.cat(parts, d)
        return out

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


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
    rank of the process group. On a mesh of more axes (a sharded
    embedding over ``model``, say) the batch splits and the gradients sum
    over this rank's slice of ``axis`` only: the ranks of another axis
    hold the same rows. ``shard_optimizer_state=True`` (the JAX default,
    ZeRO-1 there) is accepted, and the optimizer slots stay whole on each
    rank: the update is the same, only the memory differs."""

    def __init__(self, mesh=None, axis="data", shard_optimizer_state=True):
        self.mesh = mesh or build_mesh()
        ax = self.mesh.axis(axis)
        self.axis = axis
        self.shard_optimizer_state = bool(shard_optimizer_state)
        self.world = ax.size
        self.rank = ax.index
        self._first = ax.ranks[0]
        self._group = ax.group  # None: the default group (a world of one)
        self._exchange = _group_up() and (ax.group is not None
                                          or self.mesh.size == 1)

    @property
    def backend(self):
        """The process group's backend ("nccl", "gloo"), or None without
        a group (a world of one, nothing exchanged)."""
        import torch.distributed as dist

        return dist.get_backend() if _group_up() else None

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
    def broadcast_(self, tensors, sharded=False):
        """Overwrite ``tensors`` with rank 0's values, in place; with
        ``sharded`` (each rank holds its own block, as a sharded
        embedding's table) with the values of the first rank of this
        rank's slice of the axis."""
        if not _group_up():
            return
        import torch.distributed as dist

        group, src = ((self._group, self._first) if sharded
                      else (None, 0))
        if sharded and not self._exchange:
            return
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src, group=group)

    def all_reduce_(self, tensor):
        """Sum ``tensor`` over the axis, in place; returns it."""
        if self._exchange:
            import torch.distributed as dist

            dist.all_reduce(tensor, group=self._group)
        return tensor

    def gather(self, obj):
        """Every rank's ``obj`` (picklable) along the axis, in rank
        order."""
        if not self._exchange:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self._group)
        return out

    @contextlib.contextmanager
    def batch_scope(self, live):
        """While a step's forward and backward run: train-mode batch norm
        sums its moments over the axis (this rank's times ``live``, 0 for
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


def layer_column_axis(extra_attr):
    """The axis an fc layer's output features split over: the last entry
    of its ``ExtraAttr(sharding=...)`` under an active mesh, when that
    axis is wider than 1; else None (the layer computes whole). Any other
    entry, and any other layer kind, leaves the value as it is: the value
    semantics of JAX's ``with_sharding_constraint``."""
    spec = getattr(extra_attr, "sharding", None)
    if _current_mesh is None or not spec or spec[-1] is None:
        return None
    ax = _current_mesh.axis(spec[-1])
    return ax if ax.size > 1 else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh: an fc layer whose
    ``ExtraAttr(sharding=)`` names one of its axes computes its column
    block there (:func:`layer_column_axis`)."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        with mesh:
            yield mesh
    finally:
        _current_mesh = prev
