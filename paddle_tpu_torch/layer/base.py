"""Layer-construction helpers shared by the layer families (paddle_tpu/
layer/base.py): the layer registry, default parameter naming
(``<layer>.w0`` / ``<layer>.wbias``, so parameter names — and checkpoints —
are the same in both packages), activation application, and per-timestep
application over SequenceBatch."""

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                            PackedSequenceBatch,
                                            SequenceBatch)
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.graph import LayerNode, ParamSpec
from paddle_tpu_torch.initializer import Normal, Uniform, Xavier, \
    default_bias_init
from paddle_tpu_torch.ops import dropout as dropout_ops
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.registry import Registry

layer_registry = Registry("layer")


def register_layer(name, aliases=()):
    """Register a layer constructor and record, on each node it builds,
    its build spec: the registry key and the bound constructor arguments
    (``node.build_spec = (name, bound)``, paddle_tpu/layer/base.py
    register_layer). The ModelConfig interchange (proto/interchange.py)
    serialises a graph from these specs."""
    import functools
    import inspect

    deco = layer_registry.register(name, aliases=aliases)

    def wrap(fn):
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):  # pragma: no cover
            sig = None

        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            node = fn(*args, **kwargs)
            if isinstance(node, LayerNode) and \
                    getattr(node, "build_spec", None) is None:
                bound = dict(kwargs)
                if sig is not None and args:
                    try:
                        bound = dict(sig.bind_partial(*args,
                                                      **kwargs).arguments)
                    except TypeError:  # pragma: no cover
                        pass
                node.build_spec = (name, bound)
            return node

        deco(recorded)
        return recorded

    return wrap


def to_list(inputs):
    if inputs is None:
        return []
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    return [inputs]


class ImageValue:
    """NHWC image activation flowing between image layers (paddle_tpu/
    layer/base.py ImageValue).

    At the graph edge an image is the reference's flat NCHW row
    [B, C*H*W]; between image layers (conv, batch norm, pool, addto) it
    stays an NHWC tensor, and ``data_of`` gives the flat NCHW view only
    where a non-image consumer (fc, a cost, the topology's output) reads
    it."""

    __slots__ = ("nhwc", "img_shape")

    def __init__(self, nhwc, img_shape):
        self.nhwc = nhwc                   # [B, H, W, C]
        self.img_shape = tuple(img_shape)  # (C, H, W)

    def flat(self):
        b, h, w, c = self.nhwc.shape
        return self.nhwc.permute(0, 3, 1, 2).reshape(b, c * h * w)


def as_nhwc(value, c, h, w):
    """An image layer's input as an NHWC tensor: as it is when an image
    layer produced it, else one transpose of the flat NCHW rows. A
    sequence's data reshapes as the JAX package's does
    (paddle_tpu/layer/base.py as_nhwc): every step an image, padding
    steps included, [B * T, H, W, C]."""
    if isinstance(value, ImageValue):
        enforce(value.img_shape == (c, h, w),
                "image shape mismatch: producer %s vs consumer (%d, %d, %d)",
                value.img_shape, c, h, w)
        return value.nhwc
    return data_of(value).reshape(-1, c, h, w).permute(0, 2, 3, 1)


def is_seq(value):
    return isinstance(value, SequenceBatch)


def image_out(value, nhwc, img_shape):
    """An image layer's output over its input ``value``: an ImageValue,
    or over a sequence (nested or not) the flat NCHW rows of every step
    with the input's sequence metadata, as the JAX package gives them
    ([B * T, C*H*W] data, the input's lengths)."""
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        b, h, w, c = nhwc.shape
        return like(value, nhwc.permute(0, 3, 1, 2).reshape(b, c * h * w))
    return ImageValue(nhwc, img_shape)


def featurewise(fn, value):
    """Apply a featurewise fn to a tensor, a SequenceBatch (padding rows
    are computed and masked downstream, as in the JAX package; a packed
    batch keeps its segment ids), a NestedSequenceBatch, an
    ImageValue (on its flat NCHW rows, the width that matmuls and
    per-feature parameters index) or SparseRows (on its dense rows, which
    ``to_dense`` refuses at reference scale; fc takes the sparse path
    instead)."""
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        return value.map_data(fn)
    if isinstance(value, ImageValue):
        return fn(value.flat())
    if isinstance(value, SparseRows):
        return fn(value.to_dense())
    return fn(value)


def reject_packed(value, what):
    """Refuse a packed batch where a layer reduces or mixes across time
    positions (paddle_tpu/layer/base.py reject_packed): a per-sequence
    reduction would collapse packed neighbours into one output, a context
    window or a chain cost would read across segment boundaries."""
    enforce(not isinstance(value, PackedSequenceBatch),
            "%s does not support packed sequence batches: it would mix "
            "packed neighbours across segment boundaries; use length "
            "bucketing (paddle_tpu_torch.data.bucketing) instead of "
            "packing", what)


def data_of(value):
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        return value.data
    if isinstance(value, ImageValue):
        return value.flat()
    if isinstance(value, SparseRows):
        return value.to_dense()
    return value


def like(value, new_data):
    """Rewrap new_data with value's sequence metadata (a packed batch's
    segment ids included, so a downstream recurrent layer still resets at
    them)."""
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        return value.map_data(lambda _: new_data)
    return new_data


def weight_spec(layer_name, idx, shape, param_attr, fan_in=None):
    attr = ParamAttr.to_attr(param_attr)
    name = attr.name or "%s.w%d" % (layer_name, idx)
    if attr.initializer is not None:
        init = attr.initializer
    elif attr.initial_max is not None:
        init = Uniform(attr.initial_min if attr.initial_min is not None
                       else -attr.initial_max, attr.initial_max)
    elif attr.initial_std is not None:
        init = Normal(attr.initial_mean, attr.initial_std)
    else:
        init = Xavier(fan_in=fan_in if fan_in is not None else shape[0])
    return ParamSpec(name, shape, init, attr)


def bias_spec(layer_name, shape, bias_attr):
    """bias_attr semantics (reference layers.py): False -> no bias, None/True
    -> default zero bias, ParamAttr -> custom."""
    if bias_attr is False:
        return None
    attr = ParamAttr.to_attr(None if bias_attr is True else bias_attr)
    name = attr.name or "%s.wbias" % layer_name
    if attr.initializer is not None:
        init = attr.initializer
    elif attr.initial_std is not None:
        init = Normal(attr.initial_mean, attr.initial_std)
    else:
        init = default_bias_init()
    return ParamSpec(name, shape, init, attr)


def mark_activation(node, act):
    """Record the output activation name on the node so cost layers can tell
    probabilities from logits (classification_cost works in log space on
    softmax outputs; paddle_tpu/layer/base.py mark_activation)."""
    node.output_activation = to_activation(act).name
    return node


def finalize(x, act, extra_attr, ctx):
    """Apply the activation, then, in train mode, dropout
    (``ExtraAttr.drop_rate``) on the layer's output, as paddle_tpu/layer/
    base.py:228-256: an elementwise activation and its dropout act on an
    ImageValue's NHWC tensor, which stays an ImageValue; anything else on
    the flat rows (a sequence's padded data included)."""
    act = to_activation(act)
    drop = extra_attr.drop_rate if extra_attr else None
    drop = drop if drop and ctx.is_train else None

    def dropped(d):
        return dropout_ops.dropout(d, drop, ctx.rng_for(d))

    if isinstance(x, ImageValue) and act.elementwise:
        y = act.apply(x.nhwc)
        return ImageValue(dropped(y) if drop else y, x.img_shape)
    out = featurewise(act.apply, x)
    return featurewise(dropped, out) if drop else out


def make_node(layer_type, forward_fn, inputs, name=None, size=0,
              param_specs=(), layer_attr=None, **kw):
    """A LayerNode; extra keywords (``seq_level=``) go to LayerNode."""
    return LayerNode(layer_type, forward_fn, inputs=to_list(inputs),
                     name=name, size=size, param_specs=param_specs,
                     extra_attr=ExtraAttr.to_attr(layer_attr), **kw)
