"""Convolution, pooling and batch normalisation on NHWC tensors
(paddle_tpu/ops/conv.py).

Layout is the JAX package's: images NHWC, conv weights HWIO
[kh, kw, C_in/groups, F], so parameters carry across by name unchanged.

``conv2d`` routes by function family, not by measurement: a conv in the
family of the hand-written kernels (stride 1, SAME padding k//2, an odd
square kernel with k <= 3, groups 1, dilation 1, one dtype, C and F
multiples of 8; ``conv_kernels.kernel_supported``) runs ``ConvSame`` -- K7
forward and data gradient, K8 filter gradient -- on either device; every
other conv (a strided stem, a stride-2 1x1) runs ``F.conv2d`` on the
permuted NCHW/OIHW views, as the JAX package computes it in XLA outside
any Pallas kernel.

Pooling pads explicitly, as the JAX package's reduce_window does: -inf
for max, zeros with true window counts for averages that exclude the
padding; ``_pool_pads`` adds the extra high-side padding that ceil-mode
output sizes need, and the image layer slices the result to the output
size (layer/conv.py img_pool).
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtype import upcast_f32
from paddle_tpu_torch.ops.conv_kernels import conv_same, kernel_supported
from paddle_tpu_torch.utils.error import enforce


def conv2d(x_nhwc, w_hwio, stride=(1, 1), padding=((0, 0), (0, 0)),
           groups=1, dilation=(1, 1)):
    """NHWC x HWIO -> NHWC convolution with symmetric zero padding
    ``((ph, ph), (pw, pw))`` (see module docstring for the routing)."""
    stride, dilation = tuple(stride), tuple(dilation)
    (pt, pb), (pl, pr) = padding
    enforce(pt == pb and pl == pr, "conv2d takes symmetric padding, got %s",
            padding)
    if kernel_supported(x_nhwc.shape, w_hwio.shape, stride, padding, groups,
                        dilation, x_nhwc.dtype, w_hwio.dtype):
        return conv_same(x_nhwc, w_hwio)
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=(pt, pl), dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def out_size(in_size, filter_size, stride, padding, caffe_mode=True):
    """Spatial output size, reference semantics (config_parser.py
    cnn_output_size): caffe_mode floors, else ceils."""
    if caffe_mode:
        return (in_size + 2 * padding - filter_size) // stride + 1
    return (in_size + 2 * padding - filter_size + stride - 1) // stride + 1


def _pool_pads(spatial, window, stride, padding, ceil_mode):
    """((top, bottom), (left, right)) for a pool over ``spatial`` (H, W):
    the reference's ceil output size may need extra high-side padding
    (paddle_tpu/ops/conv.py _pool_pads)."""
    pads = []
    for in_size, w, s, p in zip(spatial, window, stride, padding):
        if ceil_mode:
            out = -(-(in_size + 2 * p - w) // s) + 1
        else:
            out = (in_size + 2 * p - w) // s + 1
        needed = max((out - 1) * s + w - in_size - p, p)
        pads.append((p, needed))
    return tuple(pads)


def _padded_nchw(x_nhwc, pads, value):
    """x padded on H and W by ``pads`` with ``value``, as an NCHW view."""
    (pt, pb), (pl, pr) = pads
    return F.pad(x_nhwc, (0, 0, pl, pr, pt, pb),
                 value=value).permute(0, 3, 1, 2)


def max_pool2d(x_nhwc, window, stride, padding=(0, 0), ceil_mode=True):
    """Max pooling over -inf padding (a window of padding alone never
    occurs: the pad is smaller than the window). The image layer slices
    the result to the output size."""
    pads = _pool_pads(x_nhwc.shape[1:3], window, stride, padding, ceil_mode)
    y = F.max_pool2d(_padded_nchw(x_nhwc, pads, -math.inf), tuple(window),
                     tuple(stride))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x_nhwc, window, stride, padding=(0, 0), ceil_mode=True,
               exclude_padding=True):
    """Average pooling over zero padding: window sums divided by the
    number of real pixels in each window (``exclude_padding``) or by the
    window size."""
    pads = _pool_pads(x_nhwc.shape[1:3], window, stride, padding, ceil_mode)
    window, stride = tuple(window), tuple(stride)
    summed = F.avg_pool2d(_padded_nchw(x_nhwc, pads, 0.0), window, stride,
                          divisor_override=1)
    if exclude_padding:
        ones = x_nhwc.new_ones(tuple(x_nhwc.shape[:3]) + (1,))
        counts = F.avg_pool2d(_padded_nchw(ones, pads, 0.0), window, stride,
                              divisor_override=1)
        out = summed / torch.clamp(counts, min=1.0)
    else:
        out = summed / float(window[0] * window[1])
    return out.permute(0, 2, 3, 1)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm with the JAX package's custom VJP
    (paddle_tpu/ops/conv.py _bn_train_vjp_bwd): the backward saves x,
    gamma, the batch mean and 1/sqrt(var + eps) only, and computes the
    standard two-pass gradient. The moving statistics are outputs without
    a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, moving_mean, moving_var, axes, momentum,
                eps):
        xf = upcast_f32(x)
        mean = xf.mean(dim=axes)
        mean_sq = (xf * xf).mean(dim=axes)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = upcast_f32(gamma) * (xf - mean) * inv + upcast_f32(beta)
        new_mean = momentum * moving_mean + (1.0 - momentum) * mean
        new_var = momentum * moving_var + (1.0 - momentum) * var
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axes = axes
        ctx.mark_non_differentiable(new_mean, new_var)
        return y.to(x.dtype), new_mean, new_var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        x, gamma, mean, inv = ctx.saved_tensors
        axes = ctx.axes
        dyf, xf = upcast_f32(dy), upcast_f32(x)
        n = 1
        for a in axes:
            n *= x.shape[a]
        xhat = (xf - mean) * inv
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        dx = upcast_f32(gamma) * inv * (dyf - dbeta / n - xhat * (dgamma / n))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None, None, None)


def batch_norm_train(x, gamma, beta, moving_mean, moving_var, axes, momentum,
                     eps):
    """-> (y, new_moving_mean, new_moving_var). ``axes`` are the reduced
    axes (all but the last, the channel axis). Statistics in float32 (or
    wider, for float64 inputs): the
    variance is mean(x^2) - mean^2, biased and clamped at 0; the moving
    update is momentum * old + (1 - momentum) * batch (momentum is the
    layer's moving_average_fraction). y is in x's dtype."""
    return _BatchNormTrain.apply(x, gamma, beta, moving_mean, moving_var,
                                 tuple(axes), float(momentum), float(eps))


def batch_norm_infer(x, gamma, beta, moving_mean, moving_var, eps):
    """Test-mode batch norm on the moving statistics; y in x's dtype."""
    y = (upcast_f32(gamma) * (upcast_f32(x) - moving_mean)
         * torch.rsqrt(moving_var + eps) + upcast_f32(beta))
    return y.to(x.dtype)
