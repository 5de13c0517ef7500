"""Sequence layers: pooling, last_seq, first_seq, expand,
context_projection_layer, max_id (maxid), sampling_id, eos_id and print
(reference: SequencePoolLayer, SequenceLastInstanceLayer, ExpandLayer,
ContextProjection, MaxIdLayer, SamplingIdLayer, EosIdCheckLayer,
PrintLayer; paddle_tpu/layer/sequence.py), with the nested
(``agg_level``) and strided (``stride``) forms, and seq_concat,
seq_reshape, seq_slice and sub_seq (SequenceConcatLayer,
SequenceReshapeLayer, SeqSliceLayer, SubSequenceLayer). The layers that
reduce or mix across time refuse packed rows (``reject_packed``)."""

import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.layer.base import (data_of, finalize, is_seq, like,
                                         make_node, register_layer,
                                         reject_packed)
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.pooling import to_pooling
from paddle_tpu_torch.utils.error import enforce


@register_layer("pooling")
def pooling(input, pooling_type=None, name=None, bias_attr=False,
            agg_level=0, stride=-1, layer_attr=None):
    """Pool a sequence to one vector per sequence (reference:
    SequencePoolLayer). Over a nested input, ``agg_level`` pools each
    sub-sequence into an outer sequence [B, S, D]; without it the
    sub-sequences' pools are pooled again over the outer axis (max, sum,
    or else the average). ``stride`` > 0 pools each stride-window of a
    plain sequence instead, giving a sequence of ceil(T / stride) steps
    (paddle_tpu/layer/sequence.py pooling)."""
    # the JAX package declares no bias here and ignores bias_attr; None
    # (sequence_conv_pool's default) and False mean no bias, and a real
    # bias is refused rather than dropped
    enforce(bias_attr is None or bias_attr is False,
            "pooling: bias is not ported yet")
    ptype = to_pooling(pooling_type)

    def forward(params, values, ctx):
        x = values[0]
        reject_packed(x, "pooling")
        if stride > 0:
            enforce(not isinstance(x, NestedSequenceBatch),
                    "pooling stride over nested sequences is not supported")
            enforce(not getattr(ptype, "output_max_index", False),
                    "pooling stride with output_max_index is not supported")
            enforce(isinstance(x, SequenceBatch),
                    "pooling expects a sequence input")
            return _strided_pool(x, stride, ptype.name)
        if isinstance(x, NestedSequenceBatch):
            inner = x.flatten_to_subsequences()
            pooled = ptype.reduce(inner.data, inner.mask())
            if agg_level:  # each sub-sequence -> the outer sequence
                return x.outer_sequence_of(pooled)
            grouped = pooled.reshape(x.batch_size, x.max_subseqs, -1)
            m = x.outer_mask(grouped.dtype)[..., None]
            if ptype.name == "max":
                neg = torch.finfo(grouped.dtype).min
                return torch.amax(torch.where(
                    m > 0, grouped, torch.full((), neg, dtype=grouped.dtype,
                                               device=grouped.device)), dim=1)
            total = torch.sum(grouped * m, dim=1)
            if ptype.name == "sum":
                return total
            return total / torch.clamp(torch.sum(m, dim=1), min=1.0)
        enforce(isinstance(x, SequenceBatch),
                "pooling expects a sequence input")
        return ptype.reduce(x.data, x.mask())

    return make_node("pooling", forward, [input], name=name, size=input.size,
                     layer_attr=layer_attr)


def _windows(x, stride):
    """The steps of ``x`` [B, T, D] in ceil(T / stride) windows: data
    [B, K, stride, D] and mask [B, K, stride, 1], zero-padded."""
    b, t, d = x.data.shape
    k = -(-t // stride)
    pad = k * stride - t
    data = torch.nn.functional.pad(x.data, (0, 0, 0, pad))
    msk = torch.nn.functional.pad(x.mask(), (0, pad))
    return (data.reshape(b, k, stride, d),
            msk.reshape(b, k, stride)[..., None].to(x.data.dtype))


def _strided_pool(x, stride, kind):
    """Pool each stride-window of ``x``: a sequence of one step per
    window (an all-padding window pools to the dtype's least value for
    max, as in the JAX package)."""
    win, wmsk = _windows(x, stride)
    if kind == "max":
        neg = torch.finfo(win.dtype).min
        red = torch.amax(torch.where(wmsk > 0, win, torch.full(
            (), neg, dtype=win.dtype, device=win.device)), dim=2)
    else:
        red = torch.sum(win * wmsk, dim=2)
        if kind != "sum":
            count = torch.clamp(torch.sum(wmsk, dim=2), min=1.0)
            red = red / (torch.sqrt(count) if kind == "sqrt_average"
                         else count)
    return SequenceBatch(red, -(-x.lengths // stride))


def _strided_pick(x, stride, first):
    """The first or the last VALID step of each stride-window of ``x``,
    as a sequence of ceil(T / stride) steps (the reference's seq-pool
    ``stride`` mode; paddle_tpu/layer/sequence.py ``_strided_pick``)."""
    b, t, d = x.data.shape
    k = -(-t // stride)
    steps = torch.arange(k, device=x.data.device)
    if first:
        picked = x.data[:, steps * stride]
    else:
        ends = torch.minimum((steps + 1)[None, :] * stride,
                             x.lengths.long()[:, None])
        idx = torch.clamp(ends - 1, min=0)
        picked = torch.gather(x.data, 1, idx[..., None].expand(b, k, d))
    return SequenceBatch(picked, -(-x.lengths // stride))


def _instance(layer_type, input, name, agg_level, stride, layer_attr,
              first):
    def forward(params, values, ctx):
        x = values[0]
        reject_packed(x, layer_type)
        if isinstance(x, NestedSequenceBatch):
            inner = x.flatten_to_subsequences()
            if agg_level:  # each sub-sequence -> the outer sequence
                return x.outer_sequence_of(inner.first_step() if first
                                           else inner.last_step())
            if first:  # the first step of the first sub-sequence
                return x.data[:, 0, 0]
            # the JAX package's form: the last step of every
            # sub-sequence slot, [B * S, D]
            x = inner
        enforce(is_seq(x), "%s expects a sequence input", layer_type)
        if stride > 0:
            return _strided_pick(x, stride, first)
        return x.first_step() if first else x.last_step()

    return make_node(layer_type, forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("last_seq")
def last_seq(input, name=None, agg_level=0, stride=-1, layer_attr=None):
    """The last valid timestep of each sequence, [B, D] (reference:
    SequenceLastInstanceLayer). Over a nested input with ``agg_level``,
    that of each sub-sequence, as the outer sequence [B, S, D];
    ``stride`` > 0 keeps the last valid step of each stride-window, a
    sequence of ceil(T / stride) steps."""
    return _instance("last_seq", input, name, agg_level, stride, layer_attr,
                     first=False)


@register_layer("first_seq")
def first_seq(input, name=None, agg_level=0, stride=-1, layer_attr=None):
    """The first timestep of each sequence, [B, D] (of a reversed
    recurrence's output: the summary of the whole sequence);
    ``agg_level`` and ``stride`` as in :func:`last_seq`."""
    return _instance("first_seq", input, name, agg_level, stride,
                     layer_attr, first=True)


@register_layer("expand")
def expand(input, expand_as, name=None, bias_attr=False, expand_level=0,
           layer_attr=None):
    """Broadcast one row per sequence [B, D] across the timesteps of the
    sequence ``expand_as``, zero on its padding. ``expand_level`` is
    accepted and has no effect, as in the JAX package
    (paddle_tpu/layer/sequence.py expand)."""
    # as pooling: the JAX package declares no bias and ignores bias_attr
    enforce(bias_attr is None or bias_attr is False,
            "expand: bias is not ported yet")

    def forward(params, values, ctx):
        x, target = values[0], values[1]
        enforce(is_seq(target), "expand_as input must be a sequence")
        reject_packed(x, "expand")
        reject_packed(target, "expand")
        enforce(not is_seq(x), "expand of a sequence input is not "
                "supported: its rows do not broadcast over the target's "
                "steps")
        return SequenceBatch(seq_ops.expand_to(data_of(x), target.mask()),
                             target.lengths)

    return make_node("expand", forward, [input, expand_as], name=name,
                     size=input.size, layer_attr=layer_attr)


def _gather_steps(data, idx):
    """data [B, T, D] at the step indices idx [B, T']."""
    return torch.gather(data, 1, idx[..., None].expand(
        idx.shape + (data.shape[-1],)))


@register_layer("seq_concat")
def seq_concat(a, b, name=None, act=None, bias_attr=False, layer_attr=None):
    """Concatenate two sequences in time per sample: a's valid steps, then
    b's, padded to Ta + Tb (reference: SequenceConcatLayer)."""

    def forward(params, values, ctx):
        xa, xb = values[0], values[1]
        enforce(is_seq(xa) and is_seq(xb), "seq_concat expects sequences")
        reject_packed(xa, "seq_concat")
        reject_packed(xb, "seq_concat")
        ta, tb = xa.data.shape[1], xb.data.shape[1]
        t = torch.arange(ta + tb, device=xa.data.device)[None, :]
        la = xa.lengths.long()[:, None]
        lb = xb.lengths.long()[:, None]
        from_a = (t < la)[..., None]
        from_b = ((t >= la) & (t < la + lb))[..., None]
        ga = _gather_steps(xa.data, torch.clamp(t, 0, ta - 1).expand(
            xa.batch_size, -1))
        gb = _gather_steps(xb.data, torch.clamp(t - la, 0, tb - 1))
        out = torch.where(from_a, ga, torch.where(from_b, gb,
                                                  torch.zeros_like(gb)))
        return finalize(SequenceBatch(out, xa.lengths + xb.lengths), act,
                        node.extra_attr, ctx)

    node = make_node("seq_concat", forward, [a, b], name=name, size=a.size,
                     layer_attr=layer_attr)
    return node


@register_layer("seq_reshape")
def seq_reshape(input, reshape_size, name=None, act=None, bias_attr=False,
                layer_attr=None):
    """Reshape the feature width, redistributing the timesteps
    (reference: SequenceReshapeLayer): each sequence keeps its elements,
    and its length becomes length * D // reshape_size."""

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "seq_reshape expects a sequence")
        reject_packed(x, "seq_reshape")
        b, t, d = x.data.shape
        enforce((t * d) % reshape_size == 0,
                "cannot reshape %dx%d to width %d", t, d, reshape_size)
        data = x.masked_data().reshape(b, t * d // reshape_size,
                                       reshape_size)
        out = SequenceBatch(data, (x.lengths * d) // reshape_size)
        return finalize(out, act, node.extra_attr, ctx)

    node = make_node("seq_reshape", forward, [input], name=name,
                     size=reshape_size, layer_attr=layer_attr)
    return node


def _shifted(x, start, new_len):
    """Each row of ``x`` from its step ``start`` [B], ``new_len`` [B]
    steps long, zero past them."""
    t = torch.arange(x.max_len, device=x.data.device)[None, :]
    idx = torch.clamp(t + start.long()[:, None], 0, x.max_len - 1)
    data = _gather_steps(x.data, idx)
    mask = (t < new_len[:, None]).to(data.dtype)
    return SequenceBatch(data * mask[..., None], new_len)


@register_layer("seq_slice")
def seq_slice(input, starts=None, ends=None, name=None, layer_attr=None):
    """Slice each sequence to its [start, end) (reference: SeqSliceLayer);
    ``starts`` / ``ends`` are width-1 layers, or None for 0 / the
    length."""
    inputs = [input] + [x for x in (starts, ends) if x is not None]

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "seq_slice expects a sequence")
        reject_packed(x, "seq_slice")
        rest = iter(values[1:])
        s = (data_of(next(rest)).reshape(-1).to(torch.int32)
             if starts is not None else torch.zeros_like(x.lengths))
        e = (data_of(next(rest)).reshape(-1).to(torch.int32)
             if ends is not None else x.lengths)
        new_len = torch.minimum(torch.clamp(e - s, min=0), x.lengths)
        return _shifted(x, s, new_len)

    return make_node("seq_slice", forward, inputs, name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("sub_seq")
def sub_seq(input, offsets, sizes, name=None, act=None, bias_attr=False,
            layer_attr=None):
    """The sub-range [offset, offset + size) of each sequence, cut at its
    end (reference: SubSequenceLayer); ``offsets`` and ``sizes`` are
    width-1 layers."""

    def forward(params, values, ctx):
        x = values[0]
        reject_packed(x, "sub_seq")
        off = data_of(values[1]).reshape(-1).to(torch.int32)
        size = data_of(values[2]).reshape(-1).to(torch.int32)
        new_len = torch.minimum(size, torch.clamp(x.lengths - off, min=0))
        return _shifted(x, off, new_len)

    return make_node("sub_seq", forward, [input, offsets, sizes], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("context_projection_layer")
def context_projection_layer(input, context_start, context_len,
                             trainable_padding=False, name=None,
                             param_attr=None, layer_attr=None):
    """The context window as a layer of its own (reference:
    ContextProjection; ``ops.sequence.context_projection``): the
    ``context_len`` steps from ``context_start`` concatenated, width
    ``input.size * context_len``; ``trainable_padding`` owns the
    [max(1, pad rows), in] table ``<name>.w0``."""
    from paddle_tpu_torch.graph import auto_name
    from paddle_tpu_torch.layer.mixed import context_projection

    name = name or auto_name("context_projection")
    proj = context_projection(input, context_start, context_len,
                              trainable_padding, param_attr)
    specs = proj.build(name, 0)

    def forward(params, values, ctx):
        return proj.forward(params, values[0], ctx)

    return make_node("context_projection", forward, [input], name=name,
                     size=proj.size, param_specs=specs,
                     layer_attr=layer_attr)


@register_layer("max_id")
def max_id(input, name=None, layer_attr=None):
    """The index of the largest feature, int32 (reference: MaxIdLayer);
    over a sequence, one id per step."""

    def forward(params, values, ctx):
        x = values[0]
        return like(x, torch.argmax(data_of(x), dim=-1).to(torch.int32))

    return make_node("max_id", forward, [input], name=name, size=1,
                     layer_attr=layer_attr)


maxid = max_id


@register_layer("sampling_id")
def sampling_id(input, name=None, layer_attr=None):
    """An id drawn from each probability row (reference: SamplingIdLayer),
    int32, with probability proportional to max(p, 1e-20) as the JAX
    package's categorical draw over log(max(p, 1e-20)). The draw takes
    the evaluation's generator (``Topology.apply(generator=)``) and
    raises without one; the JAX package's key stream is not reproduced.
    The layer's size is the input's, as in the reference's config."""

    def forward(params, values, ctx):
        x = data_of(values[0])
        gen = ctx.rng_for(x)
        probs = torch.clamp(x.float(), min=1e-20).reshape(-1, x.shape[-1])
        ids = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return ids.reshape(x.shape[:-1]).to(torch.int32)

    return make_node("sampling_id", forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("eos_id")
def eos_id(input, eos_id, name=None, layer_attr=None):
    """1 where the input id equals ``eos_id``, else 0, int32 (reference:
    EosIdCheckLayer); over a sequence, per step."""

    def forward(params, values, ctx):
        x = values[0]
        return like(x, (data_of(x) == eos_id).to(torch.int32))

    return make_node("eos_id", forward, [input], name=name, size=1,
                     layer_attr=layer_attr)


eos = eos_id


@register_layer("print")
def print_layer(input, format=None, name=None):
    """Print the inputs' values at every evaluation and pass the first
    through (reference: PrintLayer; paddle_tpu/layer/sequence.py
    print_layer). The print reads the values back to the host, so a
    network with it cannot run under the trainer's captured graphs."""
    inputs = input if isinstance(input, (list, tuple)) else [input]

    def forward(params, values, ctx):
        from paddle_tpu_torch.layer.base import data_of

        for node_in, v in zip(inputs, values):
            print((format or "{name}: {value}").format(
                name=node_in.name, value=data_of(v).detach().cpu()))
        return values[0]

    return make_node("print", forward, list(inputs), name=name,
                     size=inputs[0].size)
