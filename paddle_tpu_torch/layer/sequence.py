"""Sequence layers: pooling, last_seq, first_seq and expand (reference:
SequencePoolLayer, SequenceLastInstanceLayer, ExpandLayer; paddle_tpu/
layer/sequence.py). Plain single-level sequences only; the nested
(``agg_level``, ``expand_level``) and strided forms come with later parts
of the port and raise."""

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layer.base import is_seq, make_node, register_layer
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
