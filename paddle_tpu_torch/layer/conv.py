"""Image layers: img_conv, img_pool, batch_norm and img_cmrnorm
(paddle_tpu/layer/conv.py; reference ExpandConvLayer/CudnnConvLayer,
PoolLayer, BatchNormLayer, CMRProjectionNormLayer).

The reference flattens feature maps to [B, C*H*W] rows in NCHW order
between layers; these layers take that flat layout at the graph edge,
compute in NHWC and hand an ``ImageValue`` (NHWC) to the next image layer,
so a chain of image layers transposes once at its entry and once where a
non-image layer reads it. Each image-producing node records
``out_img_shape`` (C, H, W) for the geometry of the next layer, like
config_parser's set_cnn_layer bookkeeping. Weights are HWIO
[fh, fw, C/groups, F], the JAX package's shape.

Not ported yet: ``img_conv(trans=True)`` (it raises) and image layers
over sequence inputs (they raise).
"""

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.graph import ParamSpec
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.layer.base import (
    ImageValue,
    as_nhwc,
    bias_spec,
    data_of,
    finalize,
    make_node,
    register_layer,
    weight_spec,
)
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.pooling import MaxPooling, to_pooling
from paddle_tpu_torch.utils.error import enforce


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def conv_geometry(input, num_channels, filter_size, stride, padding,
                  filter_size_y=None, stride_y=None, padding_y=None,
                  caffe_mode=True, dilation=(1, 1)):
    """(c, h, w, fh, fw, sh, sw, ph, pw, oh, ow) of a conv: the *_y
    overrides, dilation and the output-size rule (config_parser.py conv
    geometry)."""
    c, h, w = _img_shape(input, num_channels)
    fh = int(filter_size_y if filter_size_y is not None
             else _pair(filter_size)[0])
    fw = _pair(filter_size)[1]
    sh = int(stride_y if stride_y is not None else _pair(stride)[0])
    sw = _pair(stride)[1]
    ph = int(padding_y if padding_y is not None else _pair(padding)[0])
    pw = _pair(padding)[1]
    dil = _pair(dilation)
    oh = conv_ops.out_size(h, fh + (fh - 1) * (dil[0] - 1), sh, ph,
                           caffe_mode)
    ow = conv_ops.out_size(w, fw + (fw - 1) * (dil[1] - 1), sw, pw,
                           caffe_mode)
    return c, h, w, fh, fw, sh, sw, ph, pw, oh, ow


def _img_shape(node, num_channels=None):
    """(C, H, W) of a layer input: its ``out_img_shape``, else a square
    image of ``num_channels`` channels."""
    shape = getattr(node, "out_img_shape", None)
    if shape is not None:
        return shape
    enforce(num_channels is not None,
            "cannot infer image shape of %r; pass num_channels" % node.name)
    side = int(round((node.size // num_channels) ** 0.5))
    enforce(side * side * num_channels == node.size,
            "layer %r size %d is not square for %d channels"
            % (node.name, node.size, num_channels))
    return (num_channels, side, side)


def _to_flat(nhwc):
    b, h, w, c = nhwc.shape
    return nhwc.permute(0, 3, 1, 2).reshape(b, c * h * w)


@register_layer("img_conv")
def img_conv(input, filter_size, num_filters, name=None, num_channels=None,
             stride=1, padding=0, dilation=1, groups=1, act=None,
             bias_attr=None, param_attr=None, shared_biases=True,
             layer_attr=None, trans=False, filter_size_y=None, stride_y=None,
             padding_y=None, caffe_mode=True):
    """2-D convolution (reference: ExpandConvLayer, CudnnConvLayer):
    ``ops.conv.conv2d``, whose stride-1 SAME family runs the hand-written
    kernels."""
    enforce(not trans, "img_conv(trans=True) is not ported yet")
    c, h, w, fh, fw, sh, sw, ph, pw, oh, ow = conv_geometry(
        input, num_channels, filter_size, stride, padding, filter_size_y,
        stride_y, padding_y, caffe_mode, dilation=dilation)
    dil = _pair(dilation)
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("conv_layer")
    wspec = weight_spec(name, 0, (fh, fw, c // groups, num_filters),
                        param_attr, fan_in=c * fh * fw // groups)
    bshape = (num_filters,) if shared_biases else (num_filters * oh * ow,)
    bspec = bias_spec(name, bshape, bias_attr)
    out_shape = (num_filters, oh, ow)

    def forward(params, values, ctx):
        y = conv_ops.conv2d(as_nhwc(values[0], c, h, w), params[wspec.name],
                            stride=(sh, sw), padding=((ph, ph), (pw, pw)),
                            groups=groups, dilation=dil)
        if bspec is not None and shared_biases:
            y = y + params[bspec.name]
        if bspec is None or shared_biases:
            return finalize(ImageValue(y, out_shape), act, node.extra_attr,
                            ctx)
        return finalize(_to_flat(y) + params[bspec.name], act,
                        node.extra_attr, ctx)

    node = make_node("img_conv", forward, [input], name=name,
                     size=num_filters * oh * ow,
                     param_specs=[s for s in (wspec, bspec) if s is not None],
                     layer_attr=layer_attr)
    node.out_img_shape = out_shape
    return node


@register_layer("img_pool")
def img_pool(input, pool_size, name=None, num_channels=None, pool_type=None,
             stride=1, padding=0, layer_attr=None, pool_size_y=None,
             stride_y=None, padding_y=None, ceil_mode=True,
             exclude_mode=True):
    """2-D max or average pooling (reference: PoolLayer, CudnnPoolLayer),
    with the reference's ceil-mode output size by default."""
    c, h, w = _img_shape(input, num_channels)
    fh = int(pool_size_y if pool_size_y is not None else _pair(pool_size)[0])
    fw = _pair(pool_size)[1]
    sh = int(stride_y if stride_y is not None else _pair(stride)[0])
    sw = _pair(stride)[1]
    ph = int(padding_y if padding_y is not None else _pair(padding)[0])
    pw = _pair(padding)[1]
    ptype = to_pooling(pool_type)
    if ceil_mode:
        oh = -(-(h + 2 * ph - fh) // sh) + 1
        ow = -(-(w + 2 * pw - fw) // sw) + 1
    else:
        oh = (h + 2 * ph - fh) // sh + 1
        ow = (w + 2 * pw - fw) // sw + 1

    def forward(params, values, ctx):
        x = as_nhwc(values[0], c, h, w)
        if isinstance(ptype, MaxPooling):
            y = conv_ops.max_pool2d(x, (fh, fw), (sh, sw), (ph, pw),
                                    ceil_mode)
        else:
            y = conv_ops.avg_pool2d(x, (fh, fw), (sh, sw), (ph, pw),
                                    ceil_mode, exclude_padding=exclude_mode)
        return ImageValue(y[:, :oh, :ow, :], (c, oh, ow))

    node = make_node("img_pool", forward, [input], name=name,
                     size=c * oh * ow, layer_attr=layer_attr)
    node.out_img_shape = (c, oh, ow)
    return node


@register_layer("batch_norm")
def batch_norm(input, name=None, num_channels=None, act=None, bias_attr=None,
               param_attr=None, layer_attr=None, use_global_stats=None,
               moving_average_fraction=0.9, epsilon=1e-5, img3D=False):
    """Batch normalisation (reference: BatchNormLayer). The moving mean
    and variance are running state (``<name>.moving_mean`` /
    ``.moving_var``): a train-mode evaluation normalises with the batch
    statistics and hands the updated moving statistics to
    ``Context.update_state``; test mode normalises with the moving ones."""
    from paddle_tpu_torch.graph import auto_name

    enforce(not img3D, "batch_norm(img3D=True) is not ported yet")
    name = name or auto_name("batch_norm_layer")
    shape = getattr(input, "out_img_shape", None)
    channels = shape[0] if shape else (num_channels or input.size)
    gamma = weight_spec(name, 0, (channels,), param_attr, fan_in=channels)
    if gamma.attr.initial_std is None and gamma.attr.initializer is None:
        gamma.initializer = Constant(1.0)
    beta = bias_spec(name, (channels,),
                     bias_attr if bias_attr is not None else True)
    mean_spec = ParamSpec(name + ".moving_mean", (channels,), Constant(0.0),
                          is_state=True)
    var_spec = ParamSpec(name + ".moving_var", (channels,), Constant(1.0),
                         is_state=True)

    def forward(params, values, ctx):
        g, b = params[gamma.name], params[beta.name]
        mm, mv = params[mean_spec.name], params[var_spec.name]
        if shape:
            x = as_nhwc(values[0], *shape)
            axes = (0, 1, 2)
        else:
            x = data_of(values[0])
            enforce(x.dim() == 2, "batch_norm over sequences is not ported "
                    "yet")
            axes = (0,)
        use_stats = (use_global_stats if use_global_stats is not None
                     else not ctx.is_train)
        if use_stats:
            y = conv_ops.batch_norm_infer(x, g, b, mm, mv, epsilon)
        else:
            y, new_mean, new_var = conv_ops.batch_norm_train(
                x, g, b, mm, mv, axes, moving_average_fraction, epsilon)
            ctx.update_state(mean_spec.name, new_mean)
            ctx.update_state(var_spec.name, new_var)
        if shape and to_activation(act).elementwise:
            return finalize(ImageValue(y, shape), act, node.extra_attr, ctx)
        return finalize(_to_flat(y) if shape else y, act, node.extra_attr,
                        ctx)

    node = make_node("batch_norm", forward, [input], name=name,
                     size=input.size,
                     param_specs=[gamma, beta, mean_spec, var_spec],
                     layer_attr=layer_attr)
    if shape:
        node.out_img_shape = shape
    return node


@register_layer("img_cmrnorm")
def img_cmrnorm(input, size, scale=0.0128, power=0.75, name=None,
                num_channels=None, layer_attr=None):
    """Local response normalisation across channel maps (reference:
    CMRProjectionNormLayer; paddle_tpu/layer/conv.py:267-285). Like the
    JAX layer it hands ``scale * size`` to ``ops.conv.cross_map_norm_auto``,
    which divides it by ``size`` again: the effective alpha is ``scale``.
    Over sequence inputs it raises, as the other image layers do."""
    c, h, w = _img_shape(input, num_channels)

    def forward(params, values, ctx):
        y = conv_ops.cross_map_norm_auto(as_nhwc(values[0], c, h, w), size,
                                         scale * size, power)
        return ImageValue(y, (c, h, w))

    node = make_node("img_cmrnorm", forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)
    node.out_img_shape = (c, h, w)
    return node
