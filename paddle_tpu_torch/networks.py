"""Composite networks (paddle_tpu/networks.py; reference:
trainer_config_helpers/networks.py): the image helpers simple_img_conv_pool,
img_conv_bn_pool and vgg_16_network, simple_lstm, bidirectional_lstm,
simple_gru, bidirectional_gru, lstmemory_group, gru_group,
sequence_conv_pool (text_conv_pool) and simple_attention. Names and
keywords are the JAX package's."""

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch import layer as L
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.attention_utils import sequence_softmax_pool


def simple_img_conv_pool(input, filter_size, num_filters, pool_size, name=None,
                         pool_type=None, act=None, groups=1, conv_stride=1,
                         conv_padding=0, bias_attr=None, num_channel=None,
                         param_attr=None, pool_stride=1, pool_padding=0):
    """img_conv then img_pool (reference: simple_img_conv_pool)."""
    conv = L.img_conv(input=input, filter_size=filter_size,
                      num_filters=num_filters, num_channels=num_channel,
                      stride=conv_stride, padding=conv_padding, groups=groups,
                      act=act, bias_attr=bias_attr, param_attr=param_attr,
                      name="%s_conv" % name if name else None)
    return L.img_pool(input=conv, pool_size=pool_size, pool_type=pool_type,
                      stride=pool_stride, padding=pool_padding,
                      name="%s_pool" % name if name else None)


def img_conv_bn_pool(input, filter_size, num_filters, pool_size, name=None,
                     pool_type=None, act=None, groups=1, conv_stride=1,
                     conv_padding=0, conv_bias_attr=None, num_channel=None,
                     conv_param_attr=None, pool_stride=1, pool_padding=0,
                     bn_param_attr=None, bn_bias_attr=None):
    """img_conv (no activation), batch_norm with ``act``, then img_pool
    (reference: img_conv_bn_pool)."""
    conv = L.img_conv(input=input, filter_size=filter_size,
                      num_filters=num_filters, num_channels=num_channel,
                      stride=conv_stride, padding=conv_padding, groups=groups,
                      act=None, bias_attr=conv_bias_attr,
                      param_attr=conv_param_attr,
                      name="%s_conv" % name if name else None)
    bn = L.batch_norm(input=conv, act=act, param_attr=bn_param_attr,
                      bias_attr=bn_bias_attr,
                      name="%s_bn" % name if name else None)
    return L.img_pool(input=bn, pool_size=pool_size, pool_type=pool_type,
                      stride=pool_stride, padding=pool_padding,
                      name="%s_pool" % name if name else None)


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


def _route(kwargs):
    """Split ``fwd_*`` / ``bwd_*`` keywords to their direction; the rest go
    to both (the reference's attribute routing)."""
    fwd_kw, bwd_kw = {}, {}
    for k, v in kwargs.items():
        if k.startswith("fwd_"):
            fwd_kw[k[4:]] = v
        elif k.startswith("bwd_"):
            bwd_kw[k[4:]] = v
        else:
            fwd_kw[k] = v
            bwd_kw[k] = v
    return fwd_kw, bwd_kw


def _bidirectional(fwd, bwd, name, return_seq):
    """The two directions joined: their sequences concatenated step by
    step (``return_seq``), else the forward's last step and the
    backward's first."""
    if return_seq:
        return L.concat(input=[fwd, bwd], name=name)
    return L.concat(input=[L.last_seq(input=fwd), L.first_seq(input=bwd)],
                    name=name)


def bidirectional_lstm(input, size, name=None, return_seq=False,
                       fwd_act=None, bwd_act=None, **kwargs):
    """A forward and a reversed simple_lstm, concatenated (reference:
    bidirectional_lstm); ``fwd_*`` / ``bwd_*`` keywords go to one
    direction's simple_lstm, the others to both. Each direction is one
    K1 launch forward and one K2 backward on the card."""
    fwd_kw, bwd_kw = _route(kwargs)
    fwd = simple_lstm(input, size, name="%s_fwd" % name if name else None,
                      reverse=False, act=fwd_act, **fwd_kw)
    bwd = simple_lstm(input, size, name="%s_bwd" % name if name else None,
                      reverse=True, act=bwd_act, **bwd_kw)
    return _bidirectional(fwd, bwd, name, return_seq)


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


def bidirectional_gru(input, size, name=None, return_seq=False,
                      fwd_act=None, bwd_act=None, **kwargs):
    """A forward and a reversed simple_gru, concatenated (reference:
    networks.py bidirectional_gru); keywords routed as in
    ``bidirectional_lstm``. Each direction is one K5 launch forward and
    one K6 backward on the card."""
    fwd_kw, bwd_kw = _route(kwargs)
    fwd = simple_gru(input, size, name="%s_fwd" % name if name else None,
                     reverse=False, act=fwd_act, **fwd_kw)
    bwd = simple_gru(input, size, name="%s_bwd" % name if name else None,
                     reverse=True, act=bwd_act, **bwd_kw)
    return _bidirectional(fwd, bwd, name, return_seq)


def lstmemory_group(input, size=None, name=None, reverse=False,
                    param_attr=None, act=None, gate_act=None, state_act=None,
                    input_proj_bias_attr=None, input_proj_layer_attr=None,
                    lstm_bias_attr=None, lstm_layer_attr=None):
    """LSTM over a pre-projected sequence, the v1 DSL's recurrent_group
    spelling of lstmemory (reference: networks.py lstmemory_group). As in
    the JAX package it maps onto the fused layer, with the split
    gate-bias parameterization (``input_proj_bias_attr`` the 4*size gate
    bias, ``lstm_bias_attr`` the peephole checks), so it launches K1/K2
    like lstmemory."""
    size = size or input.size // 4
    name = name or auto_name("lstm_group")  # ref wrap_name_default
    return L.lstmemory(input=input, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, state_act=state_act,
                       bias_attr=lstm_bias_attr, param_attr=param_attr,
                       gate_bias_attr=input_proj_bias_attr,
                       layer_attr=lstm_layer_attr, name=name)


def gru_group(input, size=None, name=None, reverse=False, param_attr=None,
              act=None, gate_act=None, gru_bias_attr=None,
              gru_layer_attr=None):
    """GRU over a pre-projected sequence (reference: networks.py
    gru_group), mapped onto grumemory as in the JAX package: K5/K6."""
    size = size or input.size // 3
    name = name or auto_name("gru_group")  # ref wrap_name_default
    return L.grumemory(input=input, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, bias_attr=gru_bias_attr,
                       param_attr=param_attr, layer_attr=gru_layer_attr,
                       name=name)


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None,
                       context_proj_param_attr=None, fc_param_attr=None,
                       fc_bias_attr=None, fc_act=None, pool_bias_attr=None,
                       fc_attr=None):
    """Text convolution: a context window, an fc over it and a sequence
    pooling (reference: sequence_conv_pool / text_conv_pool). The window
    starts at ``-(context_len // 2)`` by default and has trainable
    padding when ``context_proj_param_attr`` is given."""
    start = (context_start if context_start is not None
             else -(context_len // 2))
    ctx = L.context_projection_layer(
        input=input, context_start=start, context_len=context_len,
        trainable_padding=context_proj_param_attr is not None,
        param_attr=context_proj_param_attr,
        name="%s_conv_proj" % name if name else None)
    fc = L.fc(input=ctx, size=hidden_size, act=fc_act,
              param_attr=fc_param_attr, bias_attr=fc_bias_attr,
              name="%s_conv_fc" % name if name else None)
    return L.pooling(input=fc, pooling_type=pool_type, name=name,
                     bias_attr=pool_bias_attr)


text_conv_pool = sequence_conv_pool


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


def vgg_16_network(input_image, num_channels, num_classes=1000):
    """VGG-16 (reference: vgg_16_network): five blocks of 3x3 convs (64,
    128, 256, 512, 512 filters; 2, 2, 3, 3, 3 convs) with relu, each ended
    by a 2x2 max pool of stride 2; two relu fc of 4096 with dropout 0.5;
    a softmax fc of ``num_classes``. Layer names are the JAX builder's
    (vgg<b>_conv<i>, vgg<b>_pool, vgg_fc1, vgg_fc2, vgg_out)."""

    def conv_block(ipt, num_filter, groups, num_channels_=None, name=None):
        blk = ipt
        for i in range(groups):
            blk = L.img_conv(input=blk, filter_size=3, num_filters=num_filter,
                             num_channels=num_channels_ if i == 0 else None,
                             padding=1, act=act_mod.Relu(),
                             name="%s_conv%d" % (name, i) if name else None)
        return L.img_pool(input=blk, pool_size=2, stride=2,
                          name="%s_pool" % name if name else None)

    tmp = conv_block(input_image, 64, 2, num_channels, name="vgg1")
    tmp = conv_block(tmp, 128, 2, name="vgg2")
    tmp = conv_block(tmp, 256, 3, name="vgg3")
    tmp = conv_block(tmp, 512, 3, name="vgg4")
    tmp = conv_block(tmp, 512, 3, name="vgg5")
    tmp = L.fc(input=tmp, size=4096, act=act_mod.Relu(), name="vgg_fc1")
    tmp = L.dropout(input=tmp, dropout_rate=0.5)
    tmp = L.fc(input=tmp, size=4096, act=act_mod.Relu(), name="vgg_fc2")
    tmp = L.dropout(input=tmp, dropout_rate=0.5)
    return L.fc(input=tmp, size=num_classes, act=act_mod.Softmax(),
                name="vgg_out")
