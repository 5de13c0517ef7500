"""Single-step recurrent cells for use inside recurrent_group
(paddle_tpu/layer/step.py; reference LstmStepLayer, GruStepLayer,
config_parser.py:3013, 3103): ``lstm_step``, whose cell state is its
second output (``get_output(cell, "state")``), ``gru_step`` and
``gru_step_naive``."""

import torch

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.base import (bias_spec, data_of, like, make_node,
                                         register_layer, weight_spec)
from paddle_tpu_torch.utils.error import enforce


@register_layer("lstm_step")
def lstm_step(input, state, size=None, act=None, name=None, gate_act=None,
              state_act=None, bias_attr=None, layer_attr=None):
    """One LSTM step (reference: lstm_step_layer; LstmStepLayer.cpp).
    ``input`` is the 4*size projection W x_t + W_h h_{t-1} made by a
    preceding mixed or fc layer, ``state`` is c_{t-1} (a memory). The
    bias holds the three peephole check vectors [Wci, Wcf, Wco]. The
    output is h_t; the aux output ``'state'`` (``get_output``) is c_t."""
    size = size or state.size
    enforce(input.size == 4 * size, "lstm_step input.size must be 4*size")
    enforce(state.size == size, "lstm_step state.size must equal size")
    name = name or auto_name("lstm_step")
    bspec = bias_spec(name, (3 * size,),
                      bias_attr if bias_attr is not None else True)
    g_act = to_activation(gate_act or "sigmoid").apply
    s_act = to_activation(state_act or "tanh").apply
    o_act = to_activation(act or "tanh").apply

    def cell(params, values):
        gates, c_prev = data_of(values[0]), data_of(values[1])
        zi, zf, zg, zo = torch.chunk(gates, 4, dim=-1)
        if bspec is not None:
            pi, pf, po = torch.chunk(params[bspec.name], 3, dim=-1)
        else:
            pi = pf = po = 0.0
        i = g_act(zi + c_prev * pi)
        f = g_act(zf + c_prev * pf)
        c = f * c_prev + i * s_act(zg)
        o = g_act(zo + c * po)
        return o * o_act(c), c

    def forward(params, values, ctx):
        return like(values[0], cell(params, values)[0])

    def state_out(params, values, ctx):
        return like(values[0], cell(params, values)[1])

    node = make_node("lstm_step", forward, [input, state], name=name,
                     size=size, param_specs=[bspec] if bspec else [],
                     layer_attr=layer_attr)
    node.aux_outputs = {"state": (state_out, size)}
    return node


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
