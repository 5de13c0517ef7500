"""Layer-construction helpers shared by the layer families (paddle_tpu/
layer/base.py): the layer registry, default parameter naming
(``<layer>.w0`` / ``<layer>.wbias``, so parameter names — and checkpoints —
are the same in both packages), activation application, and per-timestep
application over SequenceBatch."""

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import LayerNode, ParamSpec
from paddle_tpu_torch.initializer import Normal, Uniform, Xavier, \
    default_bias_init
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.registry import Registry

layer_registry = Registry("layer")


def register_layer(name, aliases=()):
    return layer_registry.register(name, aliases=aliases)


def to_list(inputs):
    if inputs is None:
        return []
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    return [inputs]


def is_seq(value):
    return isinstance(value, SequenceBatch)


def featurewise(fn, value):
    """Apply a featurewise fn to a tensor or a SequenceBatch (padding rows
    are computed and masked downstream, as in the JAX package)."""
    if isinstance(value, SequenceBatch):
        return value.map_data(fn)
    return fn(value)


def data_of(value):
    return value.data if isinstance(value, SequenceBatch) else value


def like(value, new_data):
    """Rewrap new_data with value's sequence metadata."""
    if isinstance(value, SequenceBatch):
        return SequenceBatch(new_data, value.lengths)
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
    """Apply the activation; dropout (ExtraAttr.drop_rate) in train mode is
    not ported yet and raises."""
    enforce(not (extra_attr and extra_attr.drop_rate and ctx.is_train),
            "dropout in train mode is not ported yet")
    return featurewise(to_activation(act).apply, x)


def make_node(layer_type, forward_fn, inputs, name=None, size=0,
              param_specs=(), layer_attr=None):
    return LayerNode(layer_type, forward_fn, inputs=to_list(inputs),
                     name=name, size=size, param_specs=param_specs,
                     extra_attr=ExtraAttr.to_attr(layer_attr))
