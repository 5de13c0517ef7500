"""Composite networks (reference: trainer_config_helpers/networks.py)."""

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import layer as L
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.attention_utils import sequence_softmax_pool


def simple_lstm(input, size, name=None, reverse=False, mat_param_attr=None,
                bias_param_attr=None, inner_param_attr=None, act=None,
                gate_act=None, state_act=None, mixed_layer_attr=None,
                lstm_cell_attr=None):
    """fc (4*size projection) + lstmemory (reference: simple_lstm)."""
    name = name or auto_name("lstm")  # ref wrap_name_default("lstm")
    proj = L.fc(input=input, size=size * 4, act=None, bias_attr=False,
                param_attr=mat_param_attr, layer_attr=mixed_layer_attr,
                name="%s_transform" % name)
    return L.lstmemory(input=proj, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, state_act=state_act,
                       bias_attr=bias_param_attr, param_attr=inner_param_attr,
                       layer_attr=lstm_cell_attr, name=name)


def simple_gru(input, size, name=None, reverse=False, mat_param_attr=None,
               bias_param_attr=None, inner_param_attr=None, act=None,
               gate_act=None, mixed_param_attr=None,
               mixed_bias_param_attr=None, mixed_layer_attr=None,
               gru_param_attr=None, gru_bias_attr=None, gru_layer_attr=None):
    """fc (3*size projection) + grumemory. Accepts both this framework's
    arg names and the v1 DSL's (reference: networks.py simple_gru —
    mixed_param_attr/gru_param_attr naming)."""
    name = name or auto_name("simple_gru")  # reference wrap_name_default
    mat_param_attr = mixed_param_attr or mat_param_attr
    inner_param_attr = gru_param_attr or inner_param_attr
    bias_param_attr = gru_bias_attr if gru_bias_attr is not None \
        else bias_param_attr
    proj_bias = mixed_bias_param_attr if mixed_bias_param_attr is not None \
        else False
    proj = L.fc(input=input, size=size * 3, act=None, bias_attr=proj_bias,
                param_attr=mat_param_attr, layer_attr=mixed_layer_attr,
                name="%s_transform" % name)
    return L.grumemory(input=proj, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, bias_attr=bias_param_attr,
                       param_attr=inner_param_attr, layer_attr=gru_layer_attr,
                       name=name)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None):
    """Additive attention (reference: simple_attention): score each encoder
    step against the decoder state (fc, expand, addto + tanh, fc to one
    score), softmax over the valid steps, weighted sum of the encoder
    sequence."""
    decoder_proj = L.fc(input=decoder_state, size=encoded_proj.size,
                        act=None, bias_attr=False,
                        param_attr=transform_param_attr,
                        name="%s_transform" % name if name else None)
    expanded = L.expand(input=decoder_proj, expand_as=encoded_proj)
    combined = L.addto(input=[encoded_proj, expanded], act=act_mod.Tanh())
    scores = L.fc(input=combined, size=1, act=None, bias_attr=False,
                  param_attr=softmax_param_attr,
                  name="%s_scores" % name if name else None)
    return sequence_softmax_pool(scores, encoded_sequence, name=name)
