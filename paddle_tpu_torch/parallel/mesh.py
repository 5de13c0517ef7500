"""The device mesh, the sharding descriptor and the data-parallel strategy
(paddle_tpu/parallel/mesh.py).

Replaces (reference): MultiGradientMachine's thread-ring data parallelism
and the pserver sync-SGD path. The JAX package pjits its train step over a
``jax.sharding.Mesh``; here the mesh is the ``torch.distributed`` process
group (distributed/multihost.py ``initialize_multihost``) times each
rank's local devices: the ranks, and within each rank its replicas, laid
out row-major, rank-major, over the named axes, with one process group
per slice of each axis across the ranks (:meth:`Mesh.axis`). Without a
process group the mesh is this process alone. :class:`NamedSharding`
(mesh plus :class:`PartitionSpec`) says which block of a global tensor a
rank holds.

A process may drive several local devices (``build_mesh(devices=[...])``,
a list of torch devices; one device may be named more than once, and its
replicas then share it, as JAX's virtual CPU devices share one CPU):
MultiGradientMachine's design, one replica of the parameters, running
state and optimizer slots per device and one thread per replica.
``PADDLE_TPU_TORCH_VIRTUAL_DEVICES=N`` makes :func:`local_device_count`
N and :func:`local_devices` N replicas round-robin over the visible
devices, the counterpart of JAX's
``--xla_force_host_platform_device_count``. Only data parallelism runs
over local replicas; tensor, sequence and pipeline parallelism run
across ranks.

:class:`DataParallel` is synchronous data parallelism over that axis:
every rank reads the same global batch and each replica trains its
contiguous share of the rows (:meth:`DataParallel.share`; near-equal
where the batch does not divide, and a replica may hold none); the
trainer (trainer.py) weights each replica's mean cost by its share of the
global rows and sums the gradients over the replicas (device adds, peer
copies between cards) and then over the ranks (``all_reduce``), so the
update is the single-process one. Train-mode batch norm reduces its
moments over the whole global batch through :func:`batch_reducer` while
a step runs.
"""

import contextlib
import os
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


VIRTUAL_DEVICES_ENV = "PADDLE_TPU_TORCH_VIRTUAL_DEVICES"


def virtual_device_count():
    """N of ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES=N``, or None when unset."""
    value = os.environ.get(VIRTUAL_DEVICES_ENV, "").strip()
    if not value:
        return None
    enforce(value.isdigit() and int(value) >= 1, "%s=%r: a device count of "
            "at least 1", VIRTUAL_DEVICES_ENV, value)
    return int(value)


def local_device_count():
    """The devices this process names: ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES``
    when set (read now), else the visible cards (1, the CPU, on a machine
    without)."""
    virtual = virtual_device_count()
    if virtual is not None:
        return virtual
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def local_devices(count=None, device=None, first=0):
    """``count`` (default :func:`local_device_count`) torch devices of
    ``device``'s type (the default device when None): the CPU that many
    times, or the visible cards round-robin from card ``first``, so
    replicas beyond the cards share them."""
    from paddle_tpu_torch.core.place import resolve_device

    kind = resolve_device(device).type
    count = local_device_count() if count is None else int(count)
    if kind != "cuda":
        return [torch.device(kind)] * count
    cards = torch.cuda.device_count()
    return [torch.device("cuda", (first + i) % cards) for i in range(count)]


def device_count():
    """The devices a mesh can span: the process group's ranks, each with
    the replicas ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES`` names (one without
    it), when a group is up; else this process's devices."""
    if _group_up():
        return world_size() * (virtual_device_count() or 1)
    return local_device_count()


def rank_devices(device=None):
    """This rank's local devices within a process group, as
    :func:`build_mesh`'s ``devices`` takes them: None for one replica a
    rank (the trainer's device), else the
    ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES`` replicas of ``device``'s type,
    round-robin over the visible cards from this host's rank's first, so
    a mesh over them spans :func:`device_count` devices."""
    k = virtual_device_count() or 1
    if k == 1:
        return None
    from paddle_tpu_torch.distributed.multihost import local_rank

    return local_devices(k, device=device, first=local_rank() * k)


class Axis:
    """One axis of a mesh as this rank sees it: its ``name``, ``size``,
    the index of this rank's first replica on it (``index``) and the
    number of consecutive indices its local replicas hold there
    (``replicas``; above 1 on the mesh's last axis only), the global
    ``ranks`` of the slice of the mesh this rank shares with the other
    members of the axis (every other coordinate equal), in axis order,
    and the process ``group`` over them (None where nothing is exchanged
    between ranks: the slice is this rank alone, or there is no process
    group)."""

    __slots__ = ("name", "size", "index", "ranks", "group", "replicas")

    def __init__(self, name, size, index, ranks, group, replicas=1):
        self.name, self.size, self.index = name, int(size), int(index)
        self.ranks, self.group = list(ranks), group
        self.replicas = int(replicas)

    def __repr__(self):
        return "Axis(%r, size=%d, index=%d%s)" % (
            self.name, self.size, self.index,
            ", replicas=%d" % self.replicas if self.replicas > 1 else "")


class Mesh:
    """Named axes over the ranks of the process group and each rank's
    local replicas (the port's ``jax.sharding.Mesh``): ``shape`` maps
    each axis name to its size; ``devices`` are the global device indices
    (rank * replicas + replica), laid out row-major over the axes as
    ``np.array(devices).reshape(sizes)`` lays out JAX's devices;
    ``local_devices`` are this rank's replicas' torch devices (``[None]``:
    one replica on the trainer's device) and ``replicas`` their number.
    The replicas of a rank are consecutive on the last axis. Each axis has
    one process group per slice across the ranks (:meth:`axis`); a
    collective over an axis runs over this rank's slice only. A context
    manager, as JAX's mesh is."""

    def __init__(self, devices, axis_names, sizes, groups=None, rank=0,
                 local_devices=None):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.local_devices = list(local_devices or [None])
        self.replicas = len(self.local_devices)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes)) if sizes else 1
        k = self.replicas
        # the ranks' layout (``devices`` are the ranks where a rank holds
        # one replica): the last axis holds each rank's replicas
        order = self.devices if k == 1 else \
            list(range(len(self.devices) // k))
        rank_sizes = list(sizes[:-1]) + [sizes[-1] // k] if sizes else []
        coords = (np.unravel_index(order.index(int(rank)), rank_sizes)
                  if sizes else ())
        layout = np.array(order).reshape(rank_sizes) if sizes else None
        self._axes = {}
        for pos, name in enumerate(self.axis_names):
            where = list(coords)
            where[pos] = slice(None)
            ranks = [int(r) for r in layout[tuple(where)]]
            last = pos == len(self.axis_names) - 1
            self._axes[name] = Axis(
                name, sizes[pos], coords[pos] * (k if last else 1), ranks,
                (groups or {}).get(name), k if last else 1)

    def axis(self, name, replicas=False):
        """This rank's :class:`Axis` ``name``: its index there, the axis
        size and the process group of its slice. An axis that spans this
        process's local replicas is refused unless ``replicas`` (only
        :class:`DataParallel` runs over them)."""
        enforce(name in self._axes, "mesh %s has no axis %r", self.shape,
                name)
        ax = self._axes[name]
        enforce(replicas or ax.replicas == 1, "mesh axis %r spans this "
                "process's %d local replicas: only DataParallel runs over "
                "local replicas (tensor, sequence and pipeline parallelism "
                "run across ranks, one device each)", name, ax.replicas)
        return ax

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "Mesh(%s)" % self.shape


def _axis_groups(order, names, sizes):
    """{axis name: this rank's process group along it}, ``order`` the
    ranks in mesh order and ``sizes`` the axes' sizes over the ranks: one
    ``torch.distributed.new_group`` per
    slice of every axis wider than 1 (every rank creates every group, in
    the same order, as new_group requires), the default group where the
    axis spans the whole world."""
    import torch.distributed as dist

    if not _group_up() or world_size() == 1:
        return {}
    me = rank()
    layout = np.array(order).reshape(sizes)
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
    """Build the mesh over the process group's ranks and this process's
    local devices. ``axes``: dict name->size or a list of (name, size);
    -1 for one axis fills it with the remaining devices. ``devices``:
    None, one replica a rank on the trainer's device; a list of torch
    devices (or their names), this process's local replicas (a device may
    repeat; every rank of a group names as many); or the ranks
    ``0..world-1`` as ints. The axes' product must be the ranks times the
    local replicas, and the replicas lie on the last axis, whose size
    they must divide. Every rank of the group must call it with the same
    axes (it creates the axes' process groups)."""
    local = [None]
    if devices is not None and any(not isinstance(d, (int, np.integer))
                                   for d in devices):
        local = [torch.device(d) for d in devices]
        enforce(len(local) >= 1, "build_mesh(devices=[]): no device")
        enforce(len({d.type for d in local}) == 1, "build_mesh: the local "
                "devices %s mix device types", [str(d) for d in local])
        devices = None
    k = len(local)
    devices = (list(range(world_size() * k)) if devices is None
               else list(devices))
    if axes is None:
        axes = {"data": len(devices)}
    items = list(axes.items()) if isinstance(axes, dict) else list(axes)
    names = [n for n, _ in items]
    sizes = [int(v) for _, v in items]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    enforce(total == len(devices),
            "mesh %s needs %d devices, have %d", dict(zip(names, sizes)),
            total, len(devices))
    enforce(k == 1 or sizes[-1] % k == 0, "mesh %s: the %d local replicas "
            "lie on the last axis, whose size %d they must divide",
            dict(zip(names, sizes)), k, sizes[-1])
    if k == 1:
        enforce(sorted(devices) == list(range(world_size())),
                "a mesh spans the ranks 0..%d of the process group, got "
                "%s", world_size() - 1, devices)
    order = devices if k == 1 else list(range(world_size()))
    groups = _axis_groups(order, names, sizes[:-1] + [sizes[-1] // k])
    return Mesh(devices, names, sizes, groups=groups, rank=rank(),
                local_devices=local)


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


# the reducer of the data-parallel step running on this thread (each
# replica's thread sets its own), read by the train-mode batch norm
# (ops/conv.py); unset outside such a step
_step = threading.local()


def batch_reducer():
    """The sum over the replicas and the ranks that train-mode batch norm
    applies to its moments while a data-parallel step runs on this
    thread, or None."""
    return getattr(_step, "reducer", None)


class _Failed:
    """A replica's exception, carried back to the step's thread."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class DataParallel:
    """Synchronous data parallelism over the mesh's ``axis``.

    Usage: ``SGD(..., parallelism=DataParallel(build_mesh(...)))`` in
    every rank of the process group, or in one process over its local
    devices (``build_mesh({"data": 4}, devices=local_devices(4))``). On a
    mesh of more axes (a sharded embedding over ``model``, say) the batch
    splits and the gradients sum over this rank's slice of ``axis`` only:
    the ranks of another axis hold the same rows; local replicas lie on
    ``axis``, the mesh's last. ``shard_optimizer_state=True`` (the JAX
    default, ZeRO-1 there) is accepted, and the optimizer slots stay
    whole on each replica: the update is the same, only the memory
    differs.

    With several local replicas (``replicas``) the trainer runs one
    thread per replica (:meth:`run_replicas`), replica 0 on the caller's;
    :meth:`sum_` is their meeting point, a barrier where replica 0's
    thread adds every replica's tensors on its device and sums the result
    over the process group."""

    def __init__(self, mesh=None, axis="data", shard_optimizer_state=True):
        self.mesh = mesh or build_mesh()
        ax = self.mesh.axis(axis, replicas=True)
        enforce(ax.replicas == self.mesh.replicas, "DataParallel over %r: "
                "the mesh's %d local replicas lie on its last axis %r",
                axis, self.mesh.replicas, self.mesh.axis_names[-1])
        self.axis = axis
        self.shard_optimizer_state = bool(shard_optimizer_state)
        self.replicas = ax.replicas
        self.devices = list(self.mesh.local_devices)
        self.world = ax.size  # the replicas along the axis, all ranks'
        self.rank = ax.index  # this rank's first replica's index there
        self._first = ax.ranks[0]
        self._group = ax.group  # None: the default group (a world of one)
        self._exchange = _group_up() and (
            ax.group is not None or self.mesh.size == self.replicas)
        self._barrier = threading.Barrier(self.replicas)
        self._slots = [None] * self.replicas
        self._sums = None

    @property
    def backend(self):
        """The process group's backend ("nccl", "gloo"), or None without
        a group (a world of one, nothing exchanged)."""
        import torch.distributed as dist

        return dist.get_backend() if _group_up() else None

    def device_of(self, replica, default):
        """Replica ``replica``'s device (``default``, the trainer's, where
        the mesh names none)."""
        dev = self.devices[replica]
        return torch.device(default) if dev is None else dev

    def check_device(self, device):
        """Refuse a trainer device the process group cannot exchange
        (NCCL needs the card), or one that is not replica 0's."""
        enforce(not (self.backend == "nccl" and device.type != "cuda"),
                "DataParallel over NCCL needs the trainer on the card, got "
                "device %s", device)
        first = self.devices[0]
        enforce(first is None or (first.type == device.type and (
            first.index is None or device.index is None
            or first.index == device.index)),
                "DataParallel: the trainer's device %s is not the mesh's "
                "first local device %s", device, first)

    def shares_card(self):
        """Whether two local replicas share one card (their backward
        passes then run on one autograd thread)."""
        cuda = [(d.index or 0) for d in self.devices
                if d is not None and d.type == "cuda"]
        return len(set(cuda)) < len(cuda)

    def capturable(self, device):
        """Whether a step's exchange can be captured in a CUDA graph on
        ``device``: NCCL's can; gloo stages CUDA tensors through the host,
        and the replica threads' meeting is Python, which a capture cannot
        hold."""
        return device.type != "cuda" or (
            self.replicas == 1 and self.backend in (None, "nccl"))

    # -- sharding descriptors (paddle_tpu/parallel/mesh.py:69-110) ---------
    def batch_sharding(self):
        """The batch's descriptor: rows split over ``axis``."""
        return NamedSharding(self.mesh, P(self.axis))

    def replicated(self):
        """The descriptor of a tensor every rank holds whole."""
        return NamedSharding(self.mesh, P())

    def slot_sharding(self, opt_state):
        """The descriptor of each optimizer slot in ``opt_state`` (dicts,
        lists and tuples of tensors): replicated, since the port keeps
        the slots whole on each rank (the class docstring)."""
        if isinstance(opt_state, dict):
            return {k: self.slot_sharding(v) for k, v in opt_state.items()}
        if isinstance(opt_state, (list, tuple)):
            return type(opt_state)(self.slot_sharding(v) for v in opt_state)
        return self.replicated()

    def _no_jit_wrapper(name):
        def refuse(self, *args, **kwargs):
            raise NotImplementedError(
                "DataParallel.%s is not ported: it wraps a jitted step of "
                "the JAX trainer; the port's trainer.SGD(parallelism=) runs "
                "the step and its exchange itself" % name)

        refuse.__name__ = name
        return refuse

    shard_train_step = _no_jit_wrapper("shard_train_step")
    shard_train_chunk = _no_jit_wrapper("shard_train_chunk")
    shard_eval_step = _no_jit_wrapper("shard_eval_step")
    del _no_jit_wrapper

    # -- the batch ----------------------------------------------------------
    def share(self, rows, replica=0):
        """(lo, hi): the contiguous rows of a global batch of ``rows``
        that this rank's replica ``replica`` trains (those JAX's
        batch_sharding gives that device); the first ``rows % world``
        replicas of the axis take one more row."""
        index = self.rank + int(replica)
        base, extra = divmod(int(rows), self.world)
        lo = index * base + min(index, extra)
        return lo, lo + base + (1 if index < extra else 0)

    @staticmethod
    def feed_rows(feed):
        """The global row count of a feed (the leading dim its slots
        share)."""
        counts = {int(_slot_tensors(v)[0].shape[0]) for v in feed.values()}
        enforce(len(counts) == 1, "feed slots disagree on the row count: %s",
                sorted(counts))
        return counts.pop()

    def shard_batch(self, feed, device=None):
        """This rank's shares of a global feed: ``(ReplicaFeeds, ((rows,
        global rows), ...))``, one feed and one pair per local replica
        (one of each for a rank that drives one device), each on its
        replica's device when ``device`` is given. A
        replica whose share is empty gets the first row to run with
        weight 0 (its cost, gradients, evaluator statistics and
        batch-norm moments count nothing), so every replica runs the same
        collectives."""
        from paddle_tpu_torch.data.feeder import ReplicaFeeds, slot_to

        total = self.feed_rows(feed)
        parts, shares = [], []
        for i in range(self.replicas):
            lo, hi = self.share(total, i)
            rows = hi - lo
            if rows == 0:
                lo, hi = 0, 1
            local = {name: _slice_rows(v, lo, hi) for name, v in feed.items()}
            if device is not None:
                dev = self.device_of(i, device)
                local = {name: slot_to(v, dev) for name, v in local.items()}
            parts.append(local)
            shares.append((rows, total))
        return ReplicaFeeds(parts), tuple(shares)

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
        """Sum ``tensor`` over the ranks of the axis, in place; returns
        it."""
        if self._exchange:
            import torch.distributed as dist

            dist.all_reduce(tensor, group=self._group)
        return tensor

    def sum_(self, tensors, replica=0):
        """Sum each of ``tensors`` over the axis, in place: over this
        process's replicas (every replica's thread calls it with its own
        tensors, in the same order; replica 0's thread adds them on its
        device, copying from other cards), then over the ranks
        (:meth:`all_reduce_`, one call a tensor, in order); every replica
        receives the sums (one replica's are its own tensors, summed in
        place)."""
        self._slots[replica] = tensors
        self._barrier.wait()
        if replica == 0:
            try:
                sums = []
                for parts in zip(*self._slots):
                    total = parts[0]
                    for t in parts[1:]:
                        total = total + t.to(total.device)
                    sums.append(self.all_reduce_(total))
                self._sums = sums
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        with torch.no_grad():
            for t, total in zip(tensors, self._sums):
                if t is not total:
                    t.copy_(total)
        return tensors

    def gather(self, obj):
        """Every rank's ``obj`` (picklable) along the axis, in rank
        order."""
        if not self._exchange:
            return [obj]
        import torch.distributed as dist

        out = [None] * (self.world // self.replicas)
        dist.all_gather_object(out, obj, group=self._group)
        return out

    @contextlib.contextmanager
    def batch_scope(self, live, replica=0):
        """While a step's forward and backward run on replica
        ``replica``'s thread: train-mode batch norm sums its moments over
        the axis (this replica's times ``live``, 0 for an empty
        share)."""
        def reduce(t):
            enforce(not (self.replicas > 1 and self.shares_card()),
                    "train-mode batch norm over %d local replicas that "
                    "share a card: the autograd engine runs one card's "
                    "backward passes on one thread, where the replicas' "
                    "backward sums would wait on each other; give each "
                    "replica its own card, or use ranks", self.replicas)
            if not live:
                t = t * 0.0
            t = t.contiguous()
            self.sum_([t], replica)
            return t

        prev = batch_reducer()
        _step.reducer = reduce
        try:
            yield
        finally:
            _step.reducer = prev

    def run_replicas(self, fn):
        """``[fn(0), ..., fn(replicas - 1)]``: replica 0 on this thread,
        every other on a thread of its own (MultiGradientMachine's
        threads), started here and joined before it returns, each inside
        its card's device context. A replica that raises breaks the
        others' barriers, and the first error is raised here once every
        replica has returned."""
        results = [None] * self.replicas

        def run(i):
            results[i] = self._run_one(fn, i)

        threads = [threading.Thread(target=run, args=(i,),
                                    name="dp-replica-%d" % i, daemon=True)
                   for i in range(1, self.replicas)]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        failed = [r.exc for r in results if isinstance(r, _Failed)]
        if failed:
            self._barrier.reset()
            first = [e for e in failed
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or failed)[0]
        return results

    def _run_one(self, fn, replica):
        dev = self.devices[replica]
        scope = (torch.cuda.device(dev) if dev is not None
                 and dev.type == "cuda" else contextlib.nullcontext())
        try:
            with scope:
                return fn(replica)
        except BaseException as exc:
            self._barrier.abort()
            return _Failed(exc)

    def __repr__(self):
        return "DataParallel(mesh=%s, axis=%r%s)" % (
            self.mesh.shape, self.axis,
            ", replicas=%d" % self.replicas if self.replicas > 1 else "")


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
