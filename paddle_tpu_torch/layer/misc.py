"""Assorted parametric layers: tensor, selective_fc, out_prod, multiplex,
prelu, gated_unit (paddle_tpu/layer/misc.py; reference TensorLayer.cpp,
SelectiveFullyConnectedLayer.cpp, OuterProdLayer.cpp, MultiplexLayer.cpp,
ParameterReluLayer.cpp and the gated_unit_layer DSL composite). Plain
PyTorch, as the JAX package computes them in XLA outside any Pallas
kernel."""

import torch

from paddle_tpu_torch.attr import ExtraAttr
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.base import (
    bias_spec,
    data_of,
    featurewise,
    finalize,
    like,
    make_node,
    mark_activation,
    register_layer,
    to_list,
    weight_spec,
)
from paddle_tpu_torch.utils.error import enforce


@register_layer("tensor")
def tensor(a, b, size, act=None, name=None, param_attr=None, bias_attr=None,
           layer_attr=None):
    """Bilinear tensor product out_k = a^T W_k b (reference: TensorLayer;
    tensor_layer DSL): the weight [size, a.size, b.size]."""
    name = name or auto_name("tensor_layer")
    wspec = weight_spec(name, 0, (size, a.size, b.size), param_attr,
                        fan_in=a.size * b.size)
    bspec = bias_spec(name, (size,), bias_attr)

    def forward(params, values, ctx):
        x, y = data_of(values[0]), data_of(values[1])
        out = torch.einsum("ba,kac,bc->bk", x, params[wspec.name], y)
        if bspec is not None:
            out = out + params[bspec.name]
        return finalize(like(values[0], out), act, node.extra_attr, ctx)

    node = make_node("tensor", forward, [a, b], name=name, size=size,
                     param_specs=[s for s in (wspec, bspec) if s],
                     layer_attr=layer_attr)
    return mark_activation(node, act)


@register_layer("selective_fc")
def selective_fc(input, select, size, act=None, name=None,
                 pass_generation=False, has_selected_colums=True,
                 mul_ratio=0.02, param_attr=None, bias_attr=None,
                 layer_attr=None):
    """Fully connected layer of the selected output columns only
    (reference: SelectiveFullyConnectedLayer): ``select`` is a 0/1 mask
    [B, size] (the dense form of the reference's sparse selection), None
    selects every column. Like the JAX package, the full product runs and
    the unselected columns are zeroed after the activation;
    ``pass_generation``, ``has_selected_colums`` and ``mul_ratio`` (the
    reference's sparse-GEMV switch) change nothing. The weight is
    [size, input.size], the reference's transposed checkpoint layout."""
    inputs = [input] + ([select] if select is not None else [])
    name = name or auto_name("selective_fc_layer")
    wspec = weight_spec(name, 0, (size, input.size), param_attr,
                        fan_in=input.size)
    bspec = bias_spec(name, (size,), bias_attr)

    def forward(params, values, ctx):
        out = torch.matmul(data_of(values[0]), params[wspec.name].t())
        if bspec is not None:
            out = out + params[bspec.name]
        out = finalize(like(values[0], out), act, node.extra_attr, ctx)
        if select is not None:
            mask = data_of(values[1])
            out = like(out, data_of(out) * mask.to(data_of(out).dtype))
        return out

    node = make_node("selective_fc", forward, inputs, name=name, size=size,
                     param_specs=[s for s in (wspec, bspec) if s],
                     layer_attr=layer_attr)
    return mark_activation(node, act)


@register_layer("out_prod")
def out_prod(input1, input2, name=None, layer_attr=None):
    """The flattened outer product of two vectors per sample (reference:
    OuterProdLayer): size1 * size2."""
    size = input1.size * input2.size

    def forward(params, values, ctx):
        x, y = data_of(values[0]), data_of(values[1])
        return like(values[0], (x[:, :, None] * y[:, None, :]).reshape(
            x.shape[0], size))

    return make_node("out_prod", forward, [input1, input2], name=name,
                     size=size, layer_attr=layer_attr)


@register_layer("multiplex")
def multiplex(input, name=None, layer_attr=None):
    """Per-sample choice among inputs (reference: MultiplexLayer):
    ``input[0]`` holds an index per row, and row b of the output is row b
    of ``input[index[b] + 1]`` (the index clipped to the inputs)."""
    inputs = to_list(input)
    enforce(len(inputs) >= 3, "multiplex needs an index layer + >=2 inputs")
    size = inputs[1].size
    for extra in inputs[2:]:
        enforce(extra.size == size, "multiplex inputs must share size")

    def forward(params, values, ctx):
        stacked = torch.stack([data_of(v) for v in values[1:]])  # [K, B, D]
        idx = torch.clamp(data_of(values[0]).reshape(-1).long(), 0,
                          stacked.shape[0] - 1)
        out = stacked.gather(0, idx[None, :, None].expand(
            1, stacked.shape[1], stacked.shape[2]))[0]
        return like(values[1], out)

    return make_node("multiplex", forward, inputs, name=name, size=size,
                     layer_attr=layer_attr)


@register_layer("prelu")
def prelu(input, name=None, partial_sum=1, param_attr=None, layer_attr=None):
    """Parametric ReLU (reference: ParameterReluLayer): ``partial_sum``
    consecutive features share one slope (1: one slope a feature,
    input.size: one for all); the weight [input.size / partial_sum]."""
    enforce(input.size % partial_sum == 0,
            "prelu: input.size must be divisible by partial_sum")
    n_slopes = input.size // partial_sum
    name = name or auto_name("prelu_layer")
    wspec = weight_spec(name, 0, (n_slopes,), param_attr, fan_in=n_slopes)

    def forward(params, values, ctx):
        w = torch.repeat_interleave(params[wspec.name], partial_sum)
        return featurewise(lambda x: torch.where(x > 0, x, x * w), values[0])

    return make_node("prelu", forward, [input], name=name, size=input.size,
                     param_specs=[wspec], layer_attr=layer_attr)


@register_layer("gated_unit")
def gated_unit(input, size, act=None, name=None, gate_attr=None,
               gate_param_attr=None, gate_bias_attr=True, inproj_attr=None,
               inproj_param_attr=None, inproj_bias_attr=True,
               layer_attr=None):
    """Gated linear unit act(X W1 + b1) * sigmoid(X W2 + b2) (reference:
    the gated_unit_layer composite; arXiv:1612.08083). ``inproj_attr`` and
    ``gate_attr`` are the ExtraAttrs (dropout) of the two branches; the
    weights are ``<name>.in.w0`` / ``.in.wbias`` and ``<name>.gate.w0`` /
    ``.gate.wbias``."""
    name = name or auto_name("gated_unit_layer")
    wspec = weight_spec(name + ".in", 0, (input.size, size),
                        inproj_param_attr, fan_in=input.size)
    bspec = bias_spec(name + ".in", (size,), inproj_bias_attr)
    gw = weight_spec(name + ".gate", 0, (input.size, size), gate_param_attr,
                     fan_in=input.size)
    gb = bias_spec(name + ".gate", (size,), gate_bias_attr)
    in_extra = ExtraAttr.to_attr(inproj_attr)
    gate_extra = ExtraAttr.to_attr(gate_attr)

    def forward(params, values, ctx):
        def linear(w, b):
            def apply(x):
                out = torch.matmul(x, params[w.name])
                return out + params[b.name] if b is not None else out
            return featurewise(apply, values[0])

        proj = finalize(linear(wspec, bspec), act or "linear", in_extra, ctx)
        gate = finalize(linear(gw, gb), "sigmoid", gate_extra, ctx)
        return like(proj, data_of(proj) * data_of(gate))

    specs = [s for s in (wspec, bspec, gw, gb) if s is not None]
    return make_node("gated_unit", forward, [input], name=name, size=size,
                     param_specs=specs, layer_attr=layer_attr)
