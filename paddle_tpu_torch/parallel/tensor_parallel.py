"""Tensor (model) parallelism: Megatron-style sharded dense pairs
(paddle_tpu/parallel/tensor_parallel.py).

The reference's only model parallelism is layer-to-device pinning
(ParallelNeuralNetwork). The JAX package splits weight matrices over a
mesh axis inside ``shard_map`` and stitches the result with one ``psum``;
here each rank of the axis multiplies by its own columns and rows and one
``all_reduce`` over the axis group stitches the result (parallel/
collectives.py: the pair's input goes through :func:`copy_to`, its
output through :func:`reduce_from`, so a loss every rank computes from
the replicated output gets the dense gradient, not N times it).
"""

import torch

from paddle_tpu_torch.parallel.collectives import copy_to, reduce_from, split
from paddle_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from paddle_tpu_torch.utils.error import enforce


def _axis(mesh, name):
    return None if name is None else mesh.axis(name)


def pair_local(x, w1, b1, w2, b2, tp, act=torch.tanh):
    """The pair on this rank's blocks: ``w1`` [d_in, d_h/N] and ``b1``
    [d_h/N] its columns, ``w2`` [d_h/N, d_out] its rows; ``x`` and the
    result [..., d_out] replicated over the axis ``tp``."""
    x = copy_to(x, tp)
    h = act(torch.matmul(x, w1) + b1)
    return reduce_from(torch.matmul(h, w2), tp) + b2


def megatron_dense_pair(x, w1, b1, w2, b2, mesh, axis="model",
                        batch_axis=None, act=torch.tanh):
    """Two dense layers with the hidden dimension sharded over ``axis``.

    Global shapes: x [..., d_in], w1 [d_in, d_h], b1 [d_h],
    w2 [d_h, d_out], b2 [d_out]; the axis size must divide d_h. Each rank
    multiplies by its columns of w1 and rows of w2; the activation runs on
    the sharded hidden, and one all-reduce closes the pair. Returns the
    global result [..., d_out]; with ``batch_axis`` (a mesh axis the
    leading dimension of x is split over, dp composed) this rank's rows
    of it. The gradients of the global inputs are their whole gradients
    on every rank (of the global loss, summed over ``batch_axis``)."""
    enforce(isinstance(mesh, Mesh), "megatron_dense_pair needs a Mesh")
    tp, dp = mesh.axis(axis), _axis(mesh, batch_axis)
    enforce(w1.shape[1] % tp.size == 0,
            "tp axis size %d must divide hidden dim %d", tp.size,
            w1.shape[1])
    x = split(x, dp, 0)
    w1, b1, w2, b2 = (copy_to(w, dp) for w in (w1, b1, w2, b2))
    return pair_local(x, split(w1, tp, 1), split(b1, tp, 0),
                      split(w2, tp, 0), b2, tp, act)


def column_parallel_spec(mesh, axis="model"):
    """NamedSharding for a [d_in, d_out] weight split on the output dim."""
    return NamedSharding(mesh, P(None, axis))


def row_parallel_spec(mesh, axis="model"):
    """NamedSharding for a [d_in, d_out] weight split on the input dim."""
    return NamedSharding(mesh, P(axis, None))


class TensorParallel:
    """Map parameter names to shardings by rule (the JAX package's GSPMD
    helper). ``rules`` is a list of (predicate_or_prefix, PartitionSpec);
    parameters matching no rule are replicated.

    >>> tp = TensorParallel(mesh, rules=[("big_fc.w", P(None, "model"))])
    >>> shardings = tp.param_shardings(params)
    >>> params = tp.place(params)   # each rank keeps its block only
    """

    def __init__(self, mesh, rules=(), axis="model"):
        self.mesh = mesh
        self.axis = axis
        self.rules = list(rules)

    def _spec_for(self, name):
        for pat, spec in self.rules:
            if callable(pat):
                if pat(name):
                    return spec
            elif name.startswith(pat):
                return spec
        return P()

    def param_shardings(self, params):
        return {k: NamedSharding(self.mesh, self._spec_for(k))
                for k in params}

    def place(self, params):
        """Each parameter's block at this rank's coordinates (a copy, so
        the global tensor can be freed)."""
        sh = self.param_shardings(params)
        return {k: sh[k].shard(v).clone() for k, v in params.items()}

    def constraint(self, x, *spec):
        """This rank's block of ``x`` under ``spec`` (the value semantics
        of JAX's ``with_sharding_constraint``: the global value does not
        change)."""
        return NamedSharding(self.mesh, P(*spec)).shard(x)
