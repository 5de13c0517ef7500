"""Image layers (paddle_tpu/layer/conv.py; reference ExpandConvLayer/
CudnnConvLayer and ConvTransLayer, PoolLayer, BatchNormLayer,
CMRProjectionNormLayer, SpatialPyramidPoolLayer, MaxOutLayer, PadLayer,
CropLayer, RotateLayer, ConvShiftLayer, BilinearInterpLayer).

The reference flattens feature maps to [B, C*H*W] rows in NCHW order
between layers; these layers take that flat layout at the graph edge,
compute in NHWC and hand an ``ImageValue`` (NHWC) to the next image layer,
so a chain of image layers transposes once at its entry and once where a
non-image layer reads it. Each image-producing node records
``out_img_shape`` (C, H, W) for the geometry of the next layer, like
config_parser's set_cnn_layer bookkeeping. Weights are HWIO
[fh, fw, C/groups, F], the JAX package's shape.

Over a sequence input an image layer reads every step as an image,
padding steps included, and gives the flat rows of every step with the
input's lengths, as the JAX package does (``layer/base.image_out``).
The transposed conv computes what the JAX package's ``lax.conv_transpose``
computes; where its output disagrees with the declared geometry
(2p != f - 1), the JAX package fails in the next layer and the port
refuses at build time (``conv_geometry``).
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.graph import ParamSpec
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.layer.base import (
    as_nhwc,
    bias_spec,
    data_of,
    finalize,
    image_out,
    like,
    make_node,
    register_layer,
    to_list,
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
                  caffe_mode=True, dilation=(1, 1), trans=False):
    """(c, h, w, fh, fw, sh, sw, ph, pw, oh, ow) of a conv: the *_y
    overrides, dilation and the output-size rule (config_parser.py conv
    geometry). ``trans`` declares (h - 1) * s - 2p + f, as the JAX
    package does; its op gives (h - 1) * s + 2p - f + 2, so the two agree
    only where 2p = f - 1, and elsewhere this refuses (the JAX package
    fails in the next layer)."""
    c, h, w = _img_shape(input, num_channels)
    fh = int(filter_size_y if filter_size_y is not None
             else _pair(filter_size)[0])
    fw = _pair(filter_size)[1]
    sh = int(stride_y if stride_y is not None else _pair(stride)[0])
    sw = _pair(stride)[1]
    ph = int(padding_y if padding_y is not None else _pair(padding)[0])
    pw = _pair(padding)[1]
    dil = _pair(dilation)
    if trans:
        enforce(2 * ph == fh - 1 and 2 * pw == fw - 1,
                "transposed conv of %d x %d filters, stride (%d, %d), "
                "padding (%d, %d) declares %d x %d, and the conv it runs "
                "gives %d x %d: the two agree only where 2 * padding = "
                "filter_size - 1 (the JAX package fails in the next layer "
                "there)", fh, fw, sh, sw, ph, pw,
                (h - 1) * sh - 2 * ph + fh, (w - 1) * sw - 2 * pw + fw,
                (h - 1) * sh + 2 * ph - fh + 2,
                (w - 1) * sw + 2 * pw - fw + 2)
        oh, ow = (h - 1) * sh - 2 * ph + fh, (w - 1) * sw - 2 * pw + fw
    else:
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
    """2-D convolution (reference: ExpandConvLayer, CudnnConvLayer;
    ``trans=True``: ConvTransLayer): ``ops.conv.conv2d``, whose stride-1
    SAME family runs the hand-written kernels, or
    ``ops.conv.conv2d_transpose``. Like the JAX layer, the transposed
    conv ignores ``dilation``; it has no feature groups (the JAX call
    fails on them)."""
    c, h, w, fh, fw, sh, sw, ph, pw, oh, ow = conv_geometry(
        input, num_channels, filter_size, stride, padding, filter_size_y,
        stride_y, padding_y, caffe_mode, dilation=dilation, trans=trans)
    enforce(not trans or groups == 1, "img_conv(trans=True) has no feature "
            "groups (the JAX package's lax.conv_transpose fails on "
            "groups=%d)", groups)
    dil = _pair(dilation)
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("conv_layer")
    wspec = weight_spec(name, 0, (fh, fw, c // groups, num_filters),
                        param_attr, fan_in=c * fh * fw // groups)
    bshape = (num_filters,) if shared_biases else (num_filters * oh * ow,)
    bspec = bias_spec(name, bshape, bias_attr)
    out_shape = (num_filters, oh, ow)

    def forward(params, values, ctx):
        x = as_nhwc(values[0], c, h, w)
        pads = ((ph, ph), (pw, pw))
        if trans:
            y = conv_ops.conv2d_transpose(x, params[wspec.name],
                                          stride=(sh, sw), padding=pads)
        else:
            y = conv_ops.conv2d(x, params[wspec.name], stride=(sh, sw),
                                padding=pads, groups=groups, dilation=dil)
        if bspec is not None and shared_biases:
            y = y + params[bspec.name]
        if bspec is None or shared_biases:
            return finalize(image_out(values[0], y, out_shape), act,
                            node.extra_attr, ctx)
        return finalize(like(values[0], _to_flat(y) + params[bspec.name]),
                        act, node.extra_attr, ctx)

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
        return image_out(values[0], y[:, :oh, :ow, :], (c, oh, ow))

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
    ``Context.update_state``; test mode normalises with the moving ones.
    ``img3D`` is accepted and unused, as in the JAX package. A sequence
    input without an image shape is normalised per feature by the moving
    statistics (test mode, ``use_global_stats=True``); batch statistics
    over it are refused, as they fail to train in the JAX package."""
    from paddle_tpu_torch.graph import auto_name

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
            axes = (0,)
        use_stats = (use_global_stats if use_global_stats is not None
                     else not ctx.is_train)
        enforce(use_stats or x.dim() == 2 or shape, "batch_norm: batch "
                "statistics over a sequence input are per step ([T, D], "
                "against [D] parameters); their gradient fails in the JAX "
                "package, and the port refuses them (test mode and "
                "use_global_stats=True normalise by the moving statistics)")
        if use_stats:
            y = conv_ops.batch_norm_infer(x, g, b, mm, mv, epsilon)
        else:
            y, new_mean, new_var = conv_ops.batch_norm_train(
                x, g, b, mm, mv, axes, moving_average_fraction, epsilon)
            ctx.update_state(mean_spec.name, new_mean)
            ctx.update_state(var_spec.name, new_var)
        if not shape:
            return finalize(like(values[0], y), act, node.extra_attr, ctx)
        if to_activation(act).elementwise:
            return finalize(image_out(values[0], y, shape), act,
                            node.extra_attr, ctx)
        return finalize(like(values[0], _to_flat(y)), act, node.extra_attr,
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
    which divides it by ``size`` again: the effective alpha is ``scale``."""
    c, h, w = _img_shape(input, num_channels)

    def forward(params, values, ctx):
        y = conv_ops.cross_map_norm_auto(as_nhwc(values[0], c, h, w), size,
                                         scale * size, power)
        return image_out(values[0], y, (c, h, w))

    node = make_node("img_cmrnorm", forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)
    node.out_img_shape = (c, h, w)
    return node


@register_layer("spp")
def spp(input, name=None, num_channels=None, pool_type=None, pyramid_height=3,
        layer_attr=None):
    """Spatial pyramid pooling (reference: SpatialPyramidPoolLayer): the
    flat [B, sum(4^l) * C] of ``ops.conv.spatial_pyramid_pool``."""
    c, h, w = _img_shape(input, num_channels)
    ptype = "max" if isinstance(to_pooling(pool_type), MaxPooling) else "avg"
    total_bins = sum(4 ** level for level in range(pyramid_height))

    def forward(params, values, ctx):
        x = as_nhwc(values[0], c, h, w)
        return like(values[0], conv_ops.spatial_pyramid_pool(
            x, pyramid_height, ptype))

    return make_node("spp", forward, [input], name=name, size=total_bins * c,
                     layer_attr=layer_attr)


@register_layer("maxout")
def maxout(input, groups, name=None, num_channels=None, layer_attr=None):
    """Maxout over channel groups (reference: MaxOutLayer)."""
    c, h, w = _img_shape(input, num_channels)
    enforce(c % groups == 0, "maxout channels %d not divisible by groups %d",
            c, groups)

    def forward(params, values, ctx):
        x = as_nhwc(values[0], c, h, w)
        return like(values[0], _to_flat(conv_ops.maxout(x, groups)))

    node = make_node("maxout", forward, [input], name=name,
                     size=input.size // groups, layer_attr=layer_attr)
    node.out_img_shape = (c // groups, h, w)
    return node


def _nchw(value, c, h, w):
    """An image layer's input as [N, C, H, W] (the flat rows' view)."""
    return data_of(value).reshape(-1, c, h, w)


@register_layer("pad")
def pad(input, pad_c=None, pad_h=None, pad_w=None, name=None,
        layer_attr=None):
    """Zero padding of the C, H and W axes, (before, after) each
    (reference: PadLayer, function/PadOp)."""
    shape = getattr(input, "out_img_shape", None)
    enforce(shape is not None, "pad layer needs an image-shaped input")
    c, h, w = shape
    pc, ph, pw = (tuple(p or (0, 0)) for p in (pad_c, pad_h, pad_w))
    oc, oh, ow = c + sum(pc), h + sum(ph), w + sum(pw)

    def forward(params, values, ctx):
        y = F.pad(_nchw(values[0], c, h, w), pw + ph + pc)
        return like(values[0], y.reshape(-1, oc * oh * ow))

    node = make_node("pad", forward, [input], name=name, size=oc * oh * ow,
                     layer_attr=layer_attr)
    node.out_img_shape = (oc, oh, ow)
    return node


@register_layer("crop")
def crop(input, axis, offset, shape=None, name=None, layer_attr=None):
    """Crop the NCHW axes from ``axis`` on to ``shape`` (or to the shape
    of the reference input, ``input=[data, reference]``), starting at
    ``offset`` (reference: CropLayer, function/CropOp)."""
    inputs = to_list(input)
    c, h, w = _img_shape(inputs[0])
    if shape is None:
        enforce(len(inputs) == 2, "crop needs a shape or a reference input")
        shape = (1,) + tuple(inputs[1].out_img_shape)
    out, offs = [1, c, h, w], [0, 0, 0, 0]
    for i in range(axis, 4):
        out[i] = shape[i]
        offs[i] = offset[i - axis] if i - axis < len(offset) else 0
    oc, oh, ow = out[1:]

    def forward(params, values, ctx):
        x = _nchw(values[0], c, h, w)
        y = x[:, offs[1]:offs[1] + oc, offs[2]:offs[2] + oh,
              offs[3]:offs[3] + ow]
        return like(values[0], y.reshape(-1, oc * oh * ow))

    node = make_node("crop", forward, inputs, name=name, size=oc * oh * ow,
                     layer_attr=layer_attr)
    node.out_img_shape = (oc, oh, ow)
    return node


@register_layer("rotate")
def rotate(input, height, width, name=None, layer_attr=None):
    """Each feature map turned 90 degrees counter-clockwise (reference:
    RotateLayer; ``rot90`` with k=1 on the (H, W) axes)."""
    c = input.size // (height * width)

    def forward(params, values, ctx):
        y = torch.rot90(_nchw(values[0], c, height, width), k=1, dims=(2, 3))
        return like(values[0], y.reshape(-1, c * height * width))

    node = make_node("rotate", forward, [input], name=name, size=input.size,
                     layer_attr=layer_attr)
    node.out_img_shape = (c, width, height)
    return node


@register_layer("conv_shift")
def conv_shift(a, b, name=None, layer_attr=None):
    """Circular 1-D convolution: out[i] = sum over j of a[i + j - N//2]
    * b[j], with N the width of ``b`` (reference: ConvShiftLayer)."""

    def forward(params, values, ctx):
        x, k = data_of(values[0]), data_of(values[1])
        n = k.shape[-1]
        out = sum(torch.roll(x, n // 2 - j, dims=-1) * k[..., j:j + 1]
                  for j in range(n))
        return like(values[0], out)

    return make_node("conv_shift", forward, [a, b], name=name, size=a.size,
                     layer_attr=layer_attr)


@register_layer("bilinear_interp")
def bilinear_interp(input, out_size_x, out_size_y, name=None,
                    layer_attr=None):
    """Bilinear resize (reference: BilinearInterpLayer). The JAX package's
    ``jax.image.resize(method="linear")`` samples at half-pixel centres
    and, where it shrinks an axis, widens the triangle kernel by the
    scale (antialiasing): ``F.interpolate`` bilinear without corner
    alignment, with ``antialias`` where an axis shrinks (on a growing
    axis it changes nothing)."""
    c, h, w = _img_shape(input)
    shrinks = out_size_y < h or out_size_x < w

    def forward(params, values, ctx):
        x = as_nhwc(values[0], c, h, w).permute(0, 3, 1, 2)
        y = F.interpolate(x, size=(out_size_y, out_size_x), mode="bilinear",
                          align_corners=False, antialias=shrinks)
        return like(values[0], y.reshape(y.shape[0], -1))

    node = make_node("bilinear_interp", forward, [input], name=name,
                     size=c * out_size_x * out_size_y, layer_attr=layer_attr)
    node.out_img_shape = (c, out_size_y, out_size_x)
    return node
