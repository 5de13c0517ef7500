"""Sequence layers: pooling (reference: SequencePoolLayer; paddle_tpu/
layer/sequence.py). Plain single-level pooling only; the nested
(agg_level) and strided forms come with later parts of the port."""

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layer.base import make_node, register_layer
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
