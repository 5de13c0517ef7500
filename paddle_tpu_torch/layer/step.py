"""Single-step recurrent cells for use inside recurrent_group
(paddle_tpu/layer/step.py; reference GruStepLayer, config_parser.py:3103).
``gru_step`` and ``gru_step_naive`` are ported; ``lstm_step`` (and the
``get_output`` of its cell state) comes with a later part of the port."""

import torch

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.base import (bias_spec, data_of, like, make_node,
                                         register_layer, weight_spec)
from paddle_tpu_torch.utils.error import enforce


def _gru_step_impl(layer_type, input, output_mem, size, act, name, gate_act,
                   bias_attr, param_attr, layer_attr):
    size = size or output_mem.size
    enforce(input.size == 3 * size, "%s input.size must be 3*size",
            layer_type)
    enforce(output_mem.size == size, "%s output_mem.size must equal size",
            layer_type)
    name = name or auto_name(layer_type)
    # one [size, 3*size] recurrent weight laid out [update, reset,
    # candidate], and a 3*size bias on the input projection
    wspec = weight_spec(name, 0, (size, 3 * size), param_attr, fan_in=size)
    bspec = bias_spec(name, (3 * size,),
                      bias_attr if bias_attr is not None else True)
    g_act = to_activation(gate_act or "sigmoid").apply
    s_act = to_activation(act or "tanh").apply

    def forward(params, values, ctx):
        xproj, h_prev = data_of(values[0]), data_of(values[1])
        if bspec is not None:
            xproj = xproj + params[bspec.name]
        xu, xr, xc = torch.chunk(xproj, 3, dim=-1)
        w = params[wspec.name]
        zu_r, zr_r = torch.chunk(torch.matmul(h_prev, w[:, :2 * size]), 2,
                                 dim=-1)
        u = g_act(xu + zu_r)
        r = g_act(xr + zr_r)
        c = s_act(xc + torch.matmul(r * h_prev, w[:, 2 * size:]))
        return like(values[0], u * h_prev + (1.0 - u) * c)

    specs = [s for s in (wspec, bspec) if s is not None]
    return make_node(layer_type, forward, [input, output_mem], name=name,
                     size=size, param_specs=specs, layer_attr=layer_attr)


@register_layer("gru_step")
def gru_step(input, output_mem, size=None, act=None, name=None,
             gate_act=None, bias_attr=None, param_attr=None, layer_attr=None):
    """One GRU step. ``input`` is the 3*size projection of x_t, and
    ``output_mem`` the previous h (a memory); the recurrent weight lives in
    this layer. h = u * h_prev + (1 - u) * candidate, as ops.rnn.gru_step."""
    return _gru_step_impl("gru_step", input, output_mem, size, act, name,
                          gate_act, bias_attr, param_attr, layer_attr)


@register_layer("gru_step_naive")
def gru_step_naive(input, output_mem, size=None, act=None, name=None,
                   gate_act=None, bias_attr=None, param_attr=None,
                   layer_attr=None):
    """The reference's non-fused variant: the same math as gru_step."""
    return _gru_step_impl("gru_step_naive", input, output_mem, size, act,
                          name, gate_act, bias_attr, param_attr, layer_attr)
