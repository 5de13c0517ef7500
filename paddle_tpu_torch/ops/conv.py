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

Cross-map (LRN) normalisation: ``cross_map_norm`` with the JAX
package's analytic backward as an autograd Function, and
``cross_map_norm_auto``, the window sum as a banded [C, C] product in
float32 (or wider), as the JAX package computes it outside any Pallas
kernel (paddle_tpu/ops/conv.py:381-472); its bfloat16-band option
(the ``lrn_bf16_band`` flag, a TPU layout choice off by default there)
has no counterpart here.

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


def _explicit_pads(padding, spatial, window, stride, dilation):
    """((top, bottom), (left, right)) of a conv: ``padding`` as given, or
    what lax's ``"SAME"`` (output ceil(in / stride), the odd pixel at the
    bottom and right) or ``"VALID"`` (none) give."""
    if not isinstance(padding, str):
        return tuple(tuple(int(p) for p in pair) for pair in padding)
    mode = padding.upper()
    enforce(mode in ("SAME", "VALID"), "conv2d padding must be 'SAME', "
            "'VALID' or ((top, bottom), (left, right)), got %r", padding)
    if mode == "VALID":
        return ((0, 0), (0, 0))
    pads = []
    for size, k, s, d in zip(spatial, window, stride, dilation):
        extent = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + extent - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv2d(x_nhwc, w_hwio, stride=(1, 1), padding="SAME", groups=1,
           dilation=(1, 1)):
    """NHWC x HWIO -> NHWC convolution (see module docstring for the
    routing). ``padding`` is the JAX package's: ``"SAME"`` (the default),
    ``"VALID"`` or ``((top, bottom), (left, right))``; padding that is not
    symmetric (SAME over an even kernel) is an ``F.pad`` before
    ``F.conv2d``."""
    stride, dilation = tuple(stride), tuple(dilation)
    padding = _explicit_pads(padding, x_nhwc.shape[1:3], w_hwio.shape[:2],
                             stride, dilation)
    if kernel_supported(x_nhwc.shape, w_hwio.shape, stride, padding, groups,
                        dilation, x_nhwc.dtype, w_hwio.dtype):
        return conv_same(x_nhwc, w_hwio)
    (pt, pb), (pl, pr) = padding
    x = x_nhwc.permute(0, 3, 1, 2)
    if (pt, pl) != (pb, pr):
        x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
    y = F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride,
                 padding=(pt, pl), dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def out_size(in_size, filter_size, stride, padding, caffe_mode=True):
    """Spatial output size, reference semantics (config_parser.py
    cnn_output_size): caffe_mode floors, else ceils."""
    if caffe_mode:
        return (in_size + 2 * padding - filter_size) // stride + 1
    return (in_size + 2 * padding - filter_size + stride - 1) // stride + 1


def _channel_window_sum(x, size, lo, hi):
    """Sum over a sliding window of ``size`` on the channel (last) axis,
    with ``lo`` / ``hi`` zeros padded below / above."""
    c = x.shape[-1]
    padded = F.pad(x, (lo, hi))
    return sum(padded[..., i:i + c] for i in range(size))


class _CrossMapNorm(torch.autograd.Function):
    """out = x / (1 + scale/size * sum_{window} x^2)^power (reference
    CrossMapNormalOp); backward is the JAX custom VJP's three window sums
    (paddle_tpu/ops/conv.py _cmr_vjp_bwd):
    dx = dy * base^-p - 2 (scale/size) p x W^T[dy x base^(-p-1)]."""

    @staticmethod
    def forward(ctx, x, size, scale, power):
        base = 1.0 + (scale / size) * _channel_window_sum(
            x * x, size, size // 2, size - 1 - size // 2)
        ctx.save_for_backward(x, base)
        ctx.size, ctx.scale, ctx.power = size, scale, power
        return x * base ** (-power)

    @staticmethod
    def backward(ctx, dy):
        x, base = ctx.saved_tensors
        size, power = ctx.size, ctx.power
        half = size // 2
        t = dy * x * base ** (-power - 1.0)
        # the transpose of the forward window: flipped padding
        s = _channel_window_sum(t, size, size - 1 - half, half)
        dx = dy * base ** (-power) - (2.0 * ctx.scale / size * power) * x * s
        return dx, None, None, None


def cross_map_norm(x_nhwc, size, scale, power):
    """Local response normalisation across the channels of an NHWC
    tensor, in its dtype (see ``_CrossMapNorm``)."""
    return _CrossMapNorm.apply(x_nhwc, int(size), float(scale), float(power))


def _lrn_band(channels, size, dtype, device):
    """0/1 banded [C, C] matrix: column c sums the size-wide channel
    window around c (rows c - size//2 .. c + size - 1 - size//2)."""
    lo, hi = size // 2, size - 1 - size // 2
    row = torch.arange(channels, device=device)[:, None]
    col = torch.arange(channels, device=device)[None, :]
    return ((row >= col - lo) & (row <= col + hi)).to(dtype)


def cross_map_norm_auto(x_nhwc, size, scale, power):
    """LRN with the channel window sum as a banded [C, C] product in
    float32 (float64 stays float64), then cast back to x's dtype;
    autograd differentiates it (the product's transpose). Above 1024
    channels, where the band would waste products, ``cross_map_norm``."""
    c = x_nhwc.shape[-1]
    if c > 1024:
        return cross_map_norm(x_nhwc, size, scale, power)
    ctype = torch.promote_types(x_nhwc.dtype, torch.float32)
    x2 = x_nhwc.to(ctype) ** 2
    s = torch.matmul(x2.reshape(-1, c), _lrn_band(c, size, ctype,
                                                  x_nhwc.device))
    base = 1.0 + (scale / size) * s.reshape(x_nhwc.shape)
    return x_nhwc * (base ** (-power)).to(x_nhwc.dtype)


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
    a gradient.

    Inside a data-parallel step (parallel/mesh.py ``batch_reducer``) the
    moments are those of the whole global batch: the forward sums x and
    x^2 and the row count over the local replicas and the ranks, and the
    backward the sums of dy and dy * xhat; the gradients of gamma and beta
    stay this replica's, which the trainer sums with the others."""

    @staticmethod
    def forward(ctx, x, gamma, beta, moving_mean, moving_var, axes, momentum,
                eps):
        from paddle_tpu_torch.parallel.mesh import batch_reducer

        xf = upcast_f32(x)
        reduce = batch_reducer()
        ctx.reduce = reduce
        if reduce is None:
            mean = xf.mean(dim=axes)
            mean_sq = (xf * xf).mean(dim=axes)
        else:
            n = 1
            for a in axes:
                n *= x.shape[a]
            sums = reduce(torch.cat([
                xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                torch.full((1,), float(n), dtype=xf.dtype,
                           device=xf.device)]))
            c = (sums.shape[0] - 1) // 2
            ctx.count = sums[-1]
            mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
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
        if ctx.reduce is None:
            dx = upcast_f32(gamma) * inv * (dyf - dbeta / n
                                            - xhat * (dgamma / n))
        else:
            sums = ctx.reduce(torch.cat([dbeta, dgamma]))
            c = dbeta.shape[0]
            dx = upcast_f32(gamma) * inv * (
                dyf - sums[:c] / ctx.count - xhat * (sums[c:] / ctx.count))
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


def _conv_transpose_padding(k, s, padding):
    """``lax.conv_transpose``'s (before, after) pads of one spatial dim for
    ``"SAME"`` / ``"VALID"``; an explicit pair is used as given."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        enforce(False, "conv2d_transpose padding must be 'SAME', 'VALID' "
                "or (before, after) pairs, got %r", padding)
    return pad_a, pad_len - pad_a


def conv2d_transpose(x_nhwc, w_hwio, stride=(1, 1), padding="SAME"):
    """What the JAX package's ``lax.conv_transpose`` computes
    (paddle_tpu/ops/conv.py:145-153; ``transpose_kernel=False``): a conv
    over the stride-dilated input with the kernel as given (not flipped)
    and pads (before, after) per spatial dim — ``"SAME"`` and ``"VALID"``
    with lax's meaning, or explicit pairs, asymmetric ones too — output
    (h - 1) * s + 1 + before + after - f + 1. That is
    ``F.conv_transpose2d`` of the flipped, I/O-swapped kernel: at padding
    f - 1 - p where the pads are symmetric and p <= f - 1, else at padding
    0 (lax's pads of f - 1) with the difference cropped or zero-padded.
    Outside the kernels' family, as in the JAX package."""
    kh, kw = w_hwio.shape[:2]
    if isinstance(padding, str):
        (pt, pb), (pl, pr) = (_conv_transpose_padding(k, s, padding)
                              for k, s in zip((kh, kw), stride))
    else:
        (pt, pb), (pl, pr) = padding
    weight = torch.flip(w_hwio, dims=(0, 1)).permute(2, 3, 0, 1)
    x = x_nhwc.permute(0, 3, 1, 2)
    if pt == pb and pl == pr and 0 <= pt <= kh - 1 and 0 <= pl <= kw - 1:
        y = F.conv_transpose2d(x, weight, stride=tuple(stride),
                               padding=(kh - 1 - pt, kw - 1 - pl))
    else:
        y = F.pad(F.conv_transpose2d(x, weight, stride=tuple(stride)),
                  (pl - kw + 1, pr - kw + 1, pt - kh + 1, pb - kh + 1))
    return y.permute(0, 2, 3, 1)


def spatial_pyramid_pool(x_nhwc, pyramid_height, pool="max"):
    """Spatial pyramid pooling (reference: SpatialPyramidPoolLayer;
    paddle_tpu/ops/conv.py spatial_pyramid_pool): the maps pooled on 1x1,
    2x2, ..., 2^(h-1) x 2^(h-1) grids, each flattened in (H, W, C) order,
    concatenated: [B, sum(4^l) * C]."""
    b, h, w, _ = x_nhwc.shape
    fn = max_pool2d if pool == "max" else avg_pool2d
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        window = (max(-(-h // bins), 1), max(-(-w // bins), 1))
        stride = (max(h // bins if h >= bins else 1, 1),
                  max(w // bins if w >= bins else 1, 1))
        pooled = fn(x_nhwc, window, stride)[:, :bins, :bins, :]
        outs.append(pooled.reshape(b, -1))
    return torch.cat(outs, dim=-1)


def maxout(x_nhwc, groups):
    """Maxout over channel groups (reference: MaxOutLayer): C channels in
    C / groups groups of ``groups`` consecutive ones, each its maximum
    (a tie's gradient shared evenly, as the JAX package's ``max``)."""
    b, h, w, c = x_nhwc.shape
    return torch.amax(x_nhwc.reshape(b, h, w, c // groups, groups), dim=-1)
