"""Core dense layers: fc, embedding and addto (reference:
FullyConnectedLayer, TableProjection / embedding_layer, AddtoLayer).
Weights keep the JAX package's [in, out] layout, so ``x @ w`` and
parameters copy across unchanged."""

import torch

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.layer.base import (
    ImageValue,
    as_nhwc,
    bias_spec,
    data_of,
    featurewise,
    finalize,
    is_seq,
    like,
    make_node,
    mark_activation,
    register_layer,
    to_list,
    weight_spec,
)
from paddle_tpu_torch.utils.error import enforce


@register_layer("fc")
def fc(input, size, act=None, name=None, param_attr=None, bias_attr=None,
       layer_attr=None):
    """Fully connected layer over one or more inputs (summed), with bias
    and activation."""
    inputs = to_list(input)
    enforce(len(inputs) >= 1, "fc needs at least one input")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("fc_layer")
    attrs = (param_attr if isinstance(param_attr, (list, tuple))
             else [param_attr] * len(inputs))
    specs = [weight_spec(name, i, (inp.size, size), attrs[i],
                         fan_in=inp.size)
             for i, inp in enumerate(inputs)]
    bspec = bias_spec(name, (size,), bias_attr)

    def forward(params, values, ctx):
        out = featurewise(lambda d: torch.matmul(d, params[specs[0].name]),
                          values[0])
        for value, spec in zip(values[1:], specs[1:]):
            nxt = featurewise(lambda d, s=spec: torch.matmul(d, params[s.name]),
                              value)
            out = like(out, data_of(out) + data_of(nxt))
        if bspec is not None:
            out = like(out, data_of(out) + params[bspec.name])
        return finalize(out, act, node.extra_attr, ctx)

    node = make_node("fc", forward, inputs, name=name, size=size,
                     param_specs=[s for s in specs + [bspec] if s is not None],
                     layer_attr=layer_attr)
    return mark_activation(node, act)


@register_layer("embedding")
def embedding(input, size, name=None, param_attr=None, layer_attr=None):
    """Embedding lookup: int ids -> rows of a dense [vocab, size] table.
    Ids are clipped to [0, vocab-1] as paddle_tpu/layer/basic.py does."""
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("embedding_layer")
    vocab = input.size
    spec = weight_spec(name, 0, (vocab, size), param_attr, fan_in=size)

    def forward(params, values, ctx):
        table = params[spec.name]

        def gather(ids):
            return table[torch.clamp(ids, 0, vocab - 1).long()]

        return featurewise(gather, values[0])

    return make_node("embedding", forward, [input], name=name, size=size,
                     param_specs=[spec], layer_attr=layer_attr)


@register_layer("addto")
def addto(input, name=None, act=None, bias_attr=False, layer_attr=None):
    """Elementwise sum of the inputs, plus an optional bias, then the
    activation (reference: AddtoLayer). Image inputs of one shape without
    a bias (ResNet's residual add) are summed as NHWC tensors and stay an
    ImageValue."""
    inputs = to_list(input)
    enforce(len(inputs) >= 1, "addto needs at least one input")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("addto_layer")
    size = inputs[0].size
    bspec = bias_spec(name, (size,), bias_attr)
    shapes = [getattr(i, "out_img_shape", None) for i in inputs]
    img_ok = all(s is not None for s in shapes) and len(set(shapes)) == 1

    def forward(params, values, ctx):
        if (img_ok and bspec is None and not any(is_seq(v) for v in values)
                and to_activation(act).elementwise):
            y = as_nhwc(values[0], *shapes[0])
            for v in values[1:]:
                y = y + as_nhwc(v, *shapes[0])
            return finalize(ImageValue(y, shapes[0]), act, node.extra_attr,
                            ctx)
        out = data_of(values[0])
        for v in values[1:]:
            out = out + data_of(v)
        if bspec is not None:
            out = out + params[bspec.name]
        return finalize(like(values[0], out), act, node.extra_attr, ctx)

    node = make_node("addto", forward, inputs, name=name, size=size,
                     param_specs=[bspec] if bspec else [],
                     layer_attr=layer_attr)
    if img_ok:
        node.out_img_shape = shapes[0]
    return mark_activation(node, act)
