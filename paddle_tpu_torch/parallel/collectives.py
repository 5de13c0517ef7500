"""Collectives over one mesh axis, with the gradients of the JAX package's
``shard_map`` programs (parallel/mesh.py ``Axis``).

JAX transposes ``psum``, ``ppermute`` and ``all_to_all`` itself; here
each collective is a ``torch.autograd.Function`` whose backward is the
collective that gradient needs. Where a value is replicated over an axis
and every rank of it computes the same loss from it, a sum in the forward
must not sum again in the backward (``torch.distributed.nn``'s
``all_reduce`` would give N times the gradient). Megatron's conjugate
pair covers that:

* :func:`copy_to`: identity forward, sum over the axis backward (a
  replicated value that each rank uses on its own part of the work);
* :func:`reduce_from`: sum over the axis forward, identity backward (the
  partial results summed into a value every rank then uses whole).

Besides: :func:`split` (this rank's block forward, gathered backward),
:func:`gather` (gathered forward, this rank's block backward),
:func:`reduce_scatter`, :func:`shift` (a ring step forward, the reverse
step backward) and :func:`all_to_all`.

Every rank of an axis must call the same collectives in the same order,
in the forward and in the backward; the modules of this package keep
every rank's autograd graph the same shape for that.

Gloo (ranks that share one card) stages CUDA tensors through the host in
``all_reduce`` / ``all_gather`` itself; its point-to-point and
all-to-all take host tensors, so :func:`shift` and :func:`all_to_all`
stage a CUDA tensor through host memory explicitly. The arithmetic stays
on the tensor's device either way.
"""

import torch


def _dist():
    import torch.distributed as dist

    return dist


def _active(axis):
    return axis is not None and axis.size > 1 and axis.group is not None


def _staged(t, axis):
    """Whether ``t`` crosses the host for a point-to-point or all-to-all
    exchange over ``axis`` (gloo with a CUDA tensor)."""
    return t.is_cuda and _dist().get_backend(axis.group) == "gloo"


def all_reduce_sum(t, axis):
    """Sum over the axis, out of place, no gradient."""
    if not _active(axis):
        return t
    out = t.detach().clone().contiguous()
    _dist().all_reduce(out, group=axis.group)
    return out


def all_gather_cat(t, axis, dim):
    """Every rank's ``t`` concatenated along ``dim`` in axis order, no
    gradient."""
    if not _active(axis):
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    _dist().all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


def _block(t, axis, dim):
    return t.chunk(axis.size, dim)[axis.index]


def _shift_raw(t, axis, offset):
    """Send ``t`` to the rank ``offset`` places on along the axis ring and
    return what arrives from ``offset`` places back."""
    dist = _dist()
    n, i = axis.size, axis.index
    dst, src = axis.ranks[(i + offset) % n], axis.ranks[(i - offset) % n]
    staged = _staged(t, axis)
    out = t.detach().contiguous()
    if staged:
        out = out.cpu()
    got = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, dst, group=axis.group),
           dist.P2POp(dist.irecv, got, src, group=axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(t.device) if staged else got


def _all_to_all_raw(t, axis, split_dim, concat_dim):
    """Block j of ``t`` along ``split_dim`` goes to the axis' rank j; the
    blocks that arrive are concatenated along ``concat_dim`` in axis
    order."""
    dist = _dist()
    send = torch.stack(t.chunk(axis.size, split_dim)).contiguous()
    staged = _staged(t, axis)
    if staged:
        send = send.cpu()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=axis.group)
    if staged:
        got = got.to(t.device)
    return torch.cat(got.unbind(0), concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.axis, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, ctx.dim).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(all_reduce_sum(x, axis), axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.axis, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return _shift_raw(x, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, ctx.axis, -ctx.offset), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return _all_to_all_raw(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all_raw(g, ctx.axis, concat_dim, split_dim), None,
                None, None)


def copy_to(x, axis):
    """Identity forward; the gradient summed over ``axis`` backward."""
    return _CopyTo.apply(x, axis) if _active(axis) else x


def reduce_from(x, axis):
    """Sum over ``axis`` forward; the gradient as it is backward (every
    rank of the axis uses the sum whole)."""
    return _ReduceFrom.apply(x, axis) if _active(axis) else x


def split(x, axis, dim):
    """This rank's block of ``x`` along ``dim``; backward, the blocks'
    gradients gathered, so a replicated ``x`` gets its whole gradient on
    every rank. ``axis`` None or of size 1 leaves ``x`` as it is."""
    return _Split.apply(x, axis, dim) if _active(axis) else x


def gather(x, axis, dim):
    """Every rank's block concatenated along ``dim``; backward, this
    rank's block of the gradient (the consumers are replicated)."""
    return _Gather.apply(x, axis, dim) if _active(axis) else x


def reduce_scatter(x, axis, dim):
    """Sum over ``axis``, then this rank's block along ``dim``; backward,
    the blocks' gradients gathered."""
    return _ReduceScatter.apply(x, axis, dim) if _active(axis) else x


def shift(x, axis, offset=1):
    """One step of the ring: every rank sends ``x`` ``offset`` places on
    and gets the block from ``offset`` places back (JAX's ``ppermute``
    with ``[(j, (j + offset) % n)]``); backward, the reverse step."""
    return _Shift.apply(x, axis, offset) if _active(axis) else x


def all_to_all(x, axis, split_dim, concat_dim):
    """JAX's tiled ``all_to_all``: block j of ``x`` along ``split_dim``
    to rank j, the arriving blocks concatenated along ``concat_dim``."""
    return (_AllToAll.apply(x, axis, split_dim, concat_dim)
            if _active(axis) else x)
