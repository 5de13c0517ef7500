"""Pipeline parallelism: a GPipe-style microbatch pipeline over a mesh axis
(paddle_tpu/parallel/pipeline.py).

The successor to the reference's per-layer device placement
(ParallelNeuralNetwork): the ranks of a ``pipe`` axis each hold one
stage's parameters; activations flow stage to stage one neighbour step a
tick while M microbatches stream through, so every stage computes after
the fill bubble (M + N - 1 ticks, the JAX package's schedule).

The JAX package runs every stage at every tick and masks the results
(SPMD); here stage i computes only at the ticks that carry a microbatch
(i <= t < i + M) and sends zeros at the others, so the exchanges stay the
same on every rank. The whole schedule is one ``autograd.Function``: its
backward runs the ticks in reverse (GPipe), recomputing each stage's
output from the input it saved and sending the input's gradient one
stage back, so every rank makes the same exchanges in the backward too.

Stages must keep the activation's shape (the standard constraint of
stacked-block pipelines); layers of another shape run outside the
pipelined region.
"""

import torch

from paddle_tpu_torch.parallel.collectives import (_active, _shift_raw,
                                                   all_reduce_sum, copy_to,
                                                   split)
from paddle_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from paddle_tpu_torch.utils.error import enforce


def _leaves(tree):
    """The tensors of a pytree of dicts, lists and tuples, in a fixed
    order, and the function that rebuilds the tree from such a list."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]

        def rebuild(flat):
            out, i = {}, 0
            for k, (leaves, sub) in zip(keys, parts):
                out[k] = sub(flat[i:i + len(leaves)])
                i += len(leaves)
            return out

        return [l for leaves, _ in parts for l in leaves], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_leaves(v) for v in tree]

        def rebuild(flat):
            out, i = [], 0
            for leaves, sub in parts:
                out.append(sub(flat[i:i + len(leaves)]))
                i += len(leaves)
            return type(tree)(out)

        return [l for leaves, _ in parts for l in leaves], rebuild
    return [tree], lambda flat: flat[0]


def tree_map(fn, *trees):
    leaves = [_leaves(t)[0] for t in trees]
    return _leaves(trees[0])[1]([fn(*xs) for xs in zip(*leaves)])


def _ring(t, axis, offset):
    return _shift_raw(t, axis, offset) if _active(axis) else t


class _Pipeline(torch.autograd.Function):
    """The tick schedule as one differentiable step: inputs this rank's
    microbatches [M, mb, ...] and its stage's parameter leaves; output
    the last stage's results on every rank of the axis."""

    @staticmethod
    def forward(ctx, stage_fn, rebuild, pipe, xs, *leaves):
        n_micro, n, idx = xs.shape[0], pipe.size, pipe.index
        params = rebuild(list(leaves))
        ticks = n_micro + n - 1
        inputs = {}
        outs = torch.zeros_like(xs)
        state = None
        for t in range(ticks):
            m = t - idx
            if 0 <= m < n_micro:
                x_in = xs[m] if idx == 0 else state
                inputs[m] = x_in
                y = stage_fn(params, x_in)
                if idx == n - 1:
                    outs[m] = y
            else:
                y = torch.zeros_like(xs[0])
            if t < ticks - 1:
                state = _ring(y, pipe, 1)
        ctx.stage_fn, ctx.rebuild, ctx.pipe = stage_fn, rebuild, pipe
        ctx.inputs, ctx.n_micro = inputs, n_micro
        ctx.save_for_backward(*leaves)
        ctx.xs_like = torch.zeros_like(xs)
        # the last stage's outputs replicated to every rank (the others
        # hold zeros): the consumers are replicated, so the gradient comes
        # back as it is
        return all_reduce_sum(outs, pipe)

    @staticmethod
    def backward(ctx, g_outs):
        pipe, n_micro = ctx.pipe, ctx.n_micro
        n, idx = pipe.size, pipe.index
        leaves = ctx.saved_tensors
        want = [l for l in leaves if l.requires_grad]
        g_leaves = [torch.zeros_like(l) for l in want]
        g_xs = ctx.xs_like
        ticks = n_micro + n - 1
        g_state = torch.zeros_like(g_xs[0])
        for t in reversed(range(ticks)):
            # the gradient of this rank's tick-t output: the next stage's
            # gradient of the state it received, one step back round the
            # ring (the forward's step at tick t, reversed)
            g_next = (_ring(g_state, pipe, -1) if t < ticks - 1
                      else torch.zeros_like(g_state))
            g_state = torch.zeros_like(g_state)
            m = t - idx
            if not 0 <= m < n_micro:
                continue
            g_y = g_next + g_outs[m] if idx == n - 1 else g_next
            with torch.enable_grad():
                x_in = ctx.inputs[m].detach().requires_grad_()
                p = [l.detach().requires_grad_(l.requires_grad)
                     for l in leaves]
                y = ctx.stage_fn(ctx.rebuild(p), x_in)
                got = torch.autograd.grad(
                    y, [x_in] + [q for q in p if q.requires_grad], g_y,
                    allow_unused=True)
            for acc, g in zip(g_leaves, got[1:]):
                if g is not None:
                    acc += g
            if idx == 0:
                g_xs[m] += got[0]
            else:
                g_state = got[0]
        # the microbatches are replicated over the axis and only stage 0
        # read them: their gradient summed over the ranks
        g_xs = all_reduce_sum(g_xs, pipe)
        it = iter(g_leaves)
        return (None, None, None, g_xs,
                *[next(it) if l.requires_grad else None for l in leaves])


def pipeline_local(stage_fn, params, xs, pipe):
    """The pipeline on this rank's stage ``params`` (a pytree of its own
    tensors) and microbatches ``xs`` [M, mb, ...] (replicated over the
    axis ``pipe``); returns the last stage's [M, mb, ...] on every rank."""
    leaves, rebuild = _leaves(params)
    return _Pipeline.apply(stage_fn, rebuild, pipe, xs, *leaves)


def pipeline_apply(stage_fn, stacked_params, microbatches, mesh, axis="pipe",
                   batch_axis=None, seq_axis=None):
    """Run ``microbatches`` through ``n_stages`` chained applications of
    ``stage_fn``, stage i's parameters living on pipe rank i.

    - ``stage_fn(params_i, x) -> y`` with ``y.shape == x.shape``;
    - ``stacked_params``: a pytree whose leaves lead with n_stages (the
      stage stack); rank i keeps stage i's slice;
    - ``microbatches``: [M, mb, ...]; ``batch_axis`` names a mesh axis the
      microbatch dim (0) is split over (each data rank pipelines its own
      microbatches), ``seq_axis`` one dim 2 (the sequence) is split over
      (``stage_fn`` must be elementwise along it).

    Returns [M, mb, ...], equal to applying stage 0..N-1 in turn to each
    microbatch (this rank's block of it with ``batch_axis`` /
    ``seq_axis``); the gradients of the global inputs are whole on every
    rank."""
    enforce(isinstance(mesh, Mesh), "pipeline_apply needs a Mesh")
    pipe = mesh.axis(axis)
    leaves, _ = _leaves(stacked_params)
    enforce(all(l.shape[0] == pipe.size for l in leaves),
            "stacked params leading axis must equal pipe axis size %d",
            pipe.size)
    dp = None if batch_axis is None else mesh.axis(batch_axis)
    sq = None if seq_axis is None else mesh.axis(seq_axis)
    xs = split(split(microbatches, dp, 0), sq, 2)
    local = tree_map(
        lambda l: split(copy_to(copy_to(l, dp), sq), pipe, 0)[0],
        stacked_params)
    return pipeline_local(stage_fn, local, xs, pipe)


def stack_stage_params(param_list):
    """[{'w': ...}, ...] per-stage parameter pytrees -> one pytree whose
    leaves lead with the stage axis (ready for the ``pipe`` sharding)."""
    return tree_map(lambda *xs: torch.stack(xs), *param_list)


def pipe_sharding(mesh, tree, axis="pipe"):
    """NamedShardings placing a stacked stage pytree over the pipe axis."""
    return tree_map(lambda l: NamedSharding(
        mesh, P(*((axis,) + (None,) * (l.dim() - 1)))), tree)
