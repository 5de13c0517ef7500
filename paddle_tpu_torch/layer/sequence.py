"""Sequence layers: pooling, last_seq, first_seq, expand,
context_projection_layer, max_id (maxid), sampling_id, eos_id and print
(reference: SequencePoolLayer, SequenceLastInstanceLayer, ExpandLayer,
ContextProjection, MaxIdLayer, SamplingIdLayer, EosIdCheckLayer,
PrintLayer; paddle_tpu/layer/sequence.py). Plain single-level sequences
only; the nested (``agg_level``, ``expand_level``) and strided forms are
not ported yet and raise."""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layer.base import (data_of, is_seq, like, make_node,
                                         register_layer)
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.pooling import to_pooling
from paddle_tpu_torch.utils.error import enforce


@register_layer("pooling")
def pooling(input, pooling_type=None, name=None, bias_attr=False,
            agg_level=0, stride=-1, layer_attr=None):
    """Pool a sequence to one vector per sequence."""
    enforce(not agg_level and stride <= 0,
            "pooling: nested (agg_level) and strided pooling are not "
            "ported yet")
    # the JAX package declares no bias here and ignores bias_attr; None
    # (sequence_conv_pool's default) and False mean no bias, and a real
    # bias is refused rather than dropped
    enforce(bias_attr is None or bias_attr is False,
            "pooling: bias is not ported yet")
    ptype = to_pooling(pooling_type)

    def forward(params, values, ctx):
        x = values[0]
        enforce(isinstance(x, SequenceBatch),
                "pooling expects a sequence input")
        return ptype.reduce(x.data, x.mask())

    return make_node("pooling", forward, [input], name=name, size=input.size,
                     layer_attr=layer_attr)


def _instance(layer_type, input, name, agg_level, stride, layer_attr, pick):
    enforce(not agg_level and stride <= 0,
            "%s: nested (agg_level) and strided (stride) selection are not "
            "ported yet", layer_type)

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "%s expects a sequence input", layer_type)
        return pick(x)

    return make_node(layer_type, forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("last_seq")
def last_seq(input, name=None, agg_level=0, stride=-1, layer_attr=None):
    """The last valid timestep of each sequence, [B, D]."""
    return _instance("last_seq", input, name, agg_level, stride, layer_attr,
                     SequenceBatch.last_step)


@register_layer("first_seq")
def first_seq(input, name=None, agg_level=0, stride=-1, layer_attr=None):
    """The first timestep of each sequence, [B, D] (of a reversed
    recurrence's output: the summary of the whole sequence)."""
    return _instance("first_seq", input, name, agg_level, stride,
                     layer_attr, SequenceBatch.first_step)


@register_layer("expand")
def expand(input, expand_as, name=None, bias_attr=False, expand_level=0,
           layer_attr=None):
    """Broadcast one row per sequence [B, D] across the timesteps of the
    sequence ``expand_as``, zero on its padding."""
    enforce(not expand_level, "expand(expand_level=...): expanding into "
            "nested sequences is not ported yet")
    # as pooling: the JAX package declares no bias and ignores bias_attr
    enforce(bias_attr is None or bias_attr is False,
            "expand: bias is not ported yet")

    def forward(params, values, ctx):
        x, target = values[0], values[1]
        enforce(is_seq(target), "expand_as input must be a sequence")
        enforce(not is_seq(x), "expand of a sequence input is not ported "
                "yet")
        return SequenceBatch(seq_ops.expand_to(x, target.mask()),
                             target.lengths)

    return make_node("expand", forward, [input, expand_as], name=name,
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
