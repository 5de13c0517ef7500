"""Sharded embedding tables (paddle_tpu/parallel/sharded_embedding.py):
sparse / embedding-parallel parity.

Replaces (reference): the sparse-remote-update path (SparseRowCpuMatrix,
SparseRemoteParameterUpdater's prefetch/push of touched rows, pserver
getParameterSparse), which let embedding tables larger than one device
live sharded across pservers.

The table is split over a mesh axis on its vocab dimension: a rank holds
its V/N rows (and the optimizer keeps slots for those rows only). A
lookup gathers the ids this rank owns, zeros elsewhere, and one
all-reduce over the axis merges the disjoint rows; the ids and the
result are replicated over the axis, so the backward scatters each row's
gradient onto the one rank that owns it and sums nothing (parallel/
collectives.py :func:`reduce_from`). Under data parallelism the shard's
gradient is summed over the ``data`` axis only, never over the table's.
"""

import torch

from paddle_tpu_torch.parallel.collectives import reduce_from, split
from paddle_tpu_torch.parallel.mesh import NamedSharding, P
from paddle_tpu_torch.utils.error import enforce


def table_sharding(mesh, axis):
    return NamedSharding(mesh, P(axis, None))


def lookup_local(shard, ids, ax, vocab):
    """Rows of the vocab-sharded table for ``ids`` (replicated over the
    axis ``ax``) from this rank's ``shard`` [V/N, D]: [..., D],
    replicated."""
    rows = vocab // ax.size
    local = ids.long() - ax.index * rows
    in_shard = (local >= 0) & (local < rows)
    got = shard[local.clamp(0, rows - 1)]
    got = torch.where(in_shard[..., None], got, torch.zeros_like(got))
    return reduce_from(got, ax)


def sharded_lookup(table, ids, mesh, axis):
    """Gather rows of a vocab-sharded table. ``table`` [V, D] global (a
    rank uses its V/N rows), ``ids`` int [...] replicated. Returns
    [..., D] replicated; the global table's gradient is whole on every
    rank."""
    ax = mesh.axis(axis)
    vocab = table.shape[0]
    enforce(vocab % ax.size == 0,
            "vocab %d must divide over mesh axis %s=%d", vocab, axis,
            ax.size)
    return lookup_local(split(table, ax, 0), ids, ax, vocab)


def sharded_embedding_layer(input, size, mesh, axis="model", name=None,
                            param_attr=None):
    """Graph-layer wrapper: an embedding whose table is vocab-sharded over
    ``axis``. Drop-in for layer.embedding when the table exceeds one
    device (Wide&Deep CTR scale). Its parameter carries the sharding
    (``ParamSpec.sharding``): ``Parameters`` keeps this rank's rows and
    gathers the global table when it is read to numpy."""
    from paddle_tpu_torch.graph import auto_name
    from paddle_tpu_torch.layer.base import featurewise, make_node, \
        weight_spec

    name = name or auto_name("sharded_embedding")
    vocab = input.size
    spec = weight_spec(name, 0, (vocab, size), param_attr, fan_in=size)
    spec.sharding = table_sharding(mesh, axis)
    ax = mesh.axis(axis)
    enforce(vocab % ax.size == 0,
            "vocab %d must divide over mesh axis %s=%d", vocab, axis,
            ax.size)

    local = spec.sharding.local_shape(spec.shape)

    def forward(params, values, ctx):
        # this rank's rows of the table: what Parameters,
        # params_from_numpy and the trainer hold
        shard = params[spec.name]
        enforce(tuple(shard.shape) == local, "sharded embedding %s takes "
                "this rank's block %s of its table, got %s", spec.name,
                local, tuple(shard.shape))
        return featurewise(
            lambda d: lookup_local(shard, torch.clamp(d, 0, vocab - 1), ax,
                                   vocab), values[0])

    return make_node("sharded_embedding", forward, [input], name=name,
                     size=size, param_specs=[spec])
