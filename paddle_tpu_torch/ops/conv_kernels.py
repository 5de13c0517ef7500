"""Stride-1 SAME convolution, forward and filter gradient: the hand-written
CUDA kernels, their plain PyTorch versions, and the autograd Function that
joins them.

``conv2d_same_fwd`` has the function and contract of paddle_tpu/ops/
pallas_conv.py ``_fwd_impl`` (the TPU kernel K7 ``_conv_fwd_kernel``):

    x  [N, H, W, C]  NHWC, float32 or bfloat16
    w  [k, k, C, F]  HWIO, x's dtype, k in {1, 3}
    -> y [N, H, W, F] in x's dtype,
    y[n,h,w,f] = sum_{dh,dw,c} x[n, h+dh-k//2, w+dw-k//2, c] * w[dh,dw,c,f]

with positions outside the image counted as zero, every product summed in
float32 and the result rounded once to x's dtype. C and F are multiples of
8.

``conv2d_same_bwd_filter`` has the function of ``_bwd_filter_impl`` (the
TPU kernel K8 ``_conv_bwdw_kernel``): from x and dy [N, H, W, F] it gives
dw [k, k, C, F] in float32, dw[dh,dw,c,f] = sum_{n,h,w} x[n, h+dh-k//2,
w+dw-k//2, c] * dy[n,h,w,f].

On a CUDA tensor each wrapper launches its kernel (csrc/conv2d_same_fwd.cu,
csrc/conv2d_same_bwdw.cu) or raises; on a CPU tensor it runs the plain
version beside it (``conv2d_same_reference``: a zero pad, then the sum over
the k*k taps of ``x_shift.reshape(M, C) @ w[dh, dw]`` in float32;
``conv2d_same_bwd_filter_reference``: the per-tap ``Z_tap^T @ dY`` in
float32), which is also the oracle the kernels are held against.

``ConvSame`` is the autograd Function (the JAX package's ``_conv_p``
custom VJP): forward is K7; backward is K7 again for dx, on dy with the
spatially flipped, in/out-transposed weight (a small torch op outside the
kernel, pallas_conv.py:300-301), and K8 for dw, cast to w's dtype. It runs
the same way on both devices, so the CPU tests exercise the backward the
card runs.

Launch counts: ``launches`` counts K7's launches (forward and data
gradient) and ``bwdw_launches`` K8's, since the last ``reset_launches()``
(a launch made to compare a kernel with its plain version counts too;
callers reset around the path they read).
"""

import threading

import torch

from paddle_tpu_torch.ops._build import (DTYPE_CODES, H100_SMS, aligned,
                                         launch, sm_count)
from paddle_tpu_torch.utils.error import enforce

launches = 0
bwdw_launches = 0
_count_lock = threading.Lock()

# K7's two paths (csrc/conv2d_same_fwd.cu), by dtype: the tensor-core path
# (bfloat16) takes 128 positions x 128 filters where F >= 128 and the grid
# keeps at least ``min_blocks_per_sm`` blocks per SM (two: its blocks have
# 256 threads), else 128 x 64; the CUDA-core path (float32) takes 128 (or
# 64) positions x 64 filters, 64 where 128 would give fewer than four of
# its 128-thread blocks per SM.
_FWD_PATHS = {
    torch.float32: {"path": "simt_f32", "code": 2, "min_blocks_per_sm": 4},
    torch.bfloat16: {"path": "tc_bf16", "code": 1, "min_blocks_per_sm": 2},
}

# The filter-gradient kernel's two paths (csrc/conv2d_same_bwdw.cu), by
# dtype: blocks of 128 dW rows x 64 filters (the tensor-core path: 128
# filters where F >= 128), walking their range of positions in chunks; the
# reduction is split into about ``target_blocks_per_sm`` blocks per SM in
# all (four for the CUDA-core path, two for the tensor-core path, whose
# blocks have twice the threads), at least ``min_positions`` positions in
# each split.
_ROWS_PER_TILE = 128
_BWDW_PATHS = {
    torch.float32: {"path": "simt_f32", "code": 2, "chunk": 16,
                    "target_blocks_per_sm": 4, "min_positions": 256},
    torch.bfloat16: {"path": "tc_bf16", "code": 1, "chunk": 32,
                     "target_blocks_per_sm": 2, "min_positions": 512},
}


def reset_launches():
    global launches, bwdw_launches
    with _count_lock:
        launches = 0
        bwdw_launches = 0


def _count_launches(n):
    global launches
    with _count_lock:
        launches += n


def _count_bwdw_launches(n):
    global bwdw_launches
    with _count_lock:
        bwdw_launches += n


def kernel_supported(x_shape, w_shape, stride, padding, groups, dilation,
                     x_dtype, w_dtype):
    """Whether the conv is in the kernels' function family: stride 1, SAME
    padding k//2, an odd square kernel with k <= 3, groups 1, dilation 1,
    x and w of one dtype (float32 or bfloat16), C and F multiples of 8
    (pallas_conv.py:363-373, without the TPU's VMEM budget and lane-fold
    width conditions). ``padding`` is ((top, bottom), (left, right))."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    kh, kw, c, f = (int(d) for d in w_shape)
    if int(x_shape[3]) != c or groups != 1 or tuple(dilation) != (1, 1):
        return False
    if tuple(stride) != (1, 1) or kh != kw or kh % 2 == 0 or kh > 3:
        return False
    pad = kh // 2
    if tuple(tuple(int(p) for p in pair) for pair in padding) != (
            (pad, pad), (pad, pad)):
        return False
    if x_dtype != w_dtype or x_dtype not in DTYPE_CODES:
        return False
    return c % 8 == 0 and f % 8 == 0 and c >= 8 and f >= 8


def _check(what, x, w_shape, other=None):
    """The wrappers' argument checks: ``x`` [N, H, W, C] of the family's
    dtypes, ``w_shape`` (k, k, C, F), and ``other`` (name, tensor, shape)
    of x's dtype and device."""
    enforce(x.dtype in DTYPE_CODES, "%s takes float32 or bfloat16 inputs, "
            "got %s", what, x.dtype)
    enforce(x.dim() == 4 and min(x.shape) >= 1,
            "%s: x must be a non-empty [N, H, W, C], got %s", what,
            tuple(x.shape))
    enforce(len(w_shape) == 4, "%s: w must be [k, k, C, F], got %s", what,
            tuple(w_shape))
    k, k2, c, f = w_shape
    enforce(k == k2 and k in (1, 3),
            "%s: the kernel is k x k with k in {1, 3}, got %s x %s", what,
            k, k2)
    enforce(c == x.shape[3], "%s: w has %d input channels, x has %d", what,
            c, x.shape[3])
    enforce(c % 8 == 0 and f % 8 == 0,
            "%s: C and F must be multiples of 8, got C=%d F=%d", what, c, f)
    if other is not None:
        name, t, shape = other
        enforce(tuple(t.shape) == tuple(shape), "%s: %s must be %s, got %s",
                what, name, tuple(shape), tuple(t.shape))
        enforce(t.dtype == x.dtype, "%s: %s must be %s, got %s", what, name,
                x.dtype, t.dtype)
        enforce(t.device == x.device, "%s: %s is on %s, x on %s", what, name,
                t.device, x.device)


def _shifted(xp, dh, dw, height, width):
    """Tap (dh, dw) of the zero-padded xp as [M, C]."""
    return xp[:, dh:dh + height, dw:dw + width, :].reshape(-1, xp.shape[3])


def conv2d_same_reference(x, w):
    """The plain PyTorch version of K7 (same dtype rules: float32 products
    and sums, one rounding to x's dtype)."""
    n, height, width, _ = x.shape
    k, _, _, f = w.shape
    p = k // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p, p, p))
    wf = w.float()
    acc = None
    for dh in range(k):
        for dw in range(k):
            part = torch.matmul(_shifted(xp, dh, dw, height, width),
                                wf[dh, dw])
            acc = part if acc is None else acc + part
    return acc.reshape(n, height, width, f).to(x.dtype)


def conv2d_same_bwd_filter_reference(x, dy, k):
    """The plain PyTorch version of K8: per tap Z_tap^T @ dY in float32 ->
    dw [k, k, C, F] float32."""
    _, height, width, c = x.shape
    f = dy.shape[3]
    p = k // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p, p, p))
    dyf = dy.float().reshape(-1, f)
    dw = torch.empty((k, k, c, f), dtype=torch.float32, device=x.device)
    for dh in range(k):
        for dw_ in range(k):
            dw[dh, dw_] = torch.matmul(
                _shifted(xp, dh, dw_, height, width).t(), dyf)
    return dw


def fwd_plan(n, height, width, f, dtype, sms=H100_SMS):
    """K7's path and tile for an output of n * height * width positions x
    f filters in ``dtype`` on a card of ``sms`` SMs, from the shapes and
    dtype alone: ``path`` ("tc_bf16" or "simt_f32") and the positions and
    filters per tile."""
    enforce(dtype in _FWD_PATHS, "conv2d_same_fwd takes float32 or bfloat16 "
            "inputs, got %s", dtype)
    cfg = _FWD_PATHS[dtype]
    min_blocks = cfg["min_blocks_per_sm"] * sms
    positions = n * height * width

    def blocks(rows, cols):
        return -(-positions // rows) * -(-f // cols)

    if cfg["path"] == "tc_bf16":
        rows = 128
        cols = 128 if f >= 128 and blocks(128, 128) >= min_blocks \
            else 64
    else:
        cols = 64
        rows = 128 if blocks(128, 64) >= min_blocks else 64
    return {"path": cfg["path"], "positions_per_tile": rows,
            "filters_per_tile": cols}


def conv2d_same_fwd(x, w):
    """K7: the stride-1 SAME conv of x [N, H, W, C] with w [k, k, C, F]
    (see module docstring), through the registered op
    ``torch.ops.paddle_tpu_torch.conv2d_same_fwd`` (``conv2d_same_fwd_op``;
    an exported program records it). After a kernel call,
    ``conv2d_same_fwd.last_launch`` holds the plan (``fwd_plan``: path and
    tile) and the grid the kernel used."""
    _check("conv2d_same_fwd", x, tuple(w.shape),
           ("w", w, tuple(w.shape)))
    return conv2d_same_fwd_op(x, w)


def _launch_fwd(x, w):
    """One call of K7 on checked inputs (a CUDA tensor, else raises)."""
    dev = x.device
    enforce(dev.type == "cuda", "conv2d_same_fwd runs on cuda or cpu "
            "tensors, got %s", dev)
    n, height, width, c = x.shape
    k, _, _, f = w.shape
    plan = fwd_plan(n, height, width, f, x.dtype, sm_count(dev))
    y = torch.empty((n, height, width, f), dtype=x.dtype, device=dev)
    info = launch("conv2d_same_fwd", dev,
                  (aligned(x), aligned(w)), (y,),
                  (n, height, width, c, f, k, _FWD_PATHS[x.dtype]["code"],
                   plan["filters_per_tile"], plan["positions_per_tile"]),
                  _count_launches)
    conv2d_same_fwd.last_launch = dict(plan, **dict(zip(
        ("filter_tiles", "position_tiles", "grid_positions_per_tile",
         "grid_filters_per_tile", "smem_bytes", "launches"), info)))
    return y


@torch.library.custom_op("paddle_tpu_torch::conv2d_same_fwd",
                         mutates_args=(), device_types="cpu")
def conv2d_same_fwd_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7 as a registered op: the plain version on the CPU, the kernel on
    the card (``_launch_fwd``, which counts the launches), the output
    shape alone while a program is traced."""
    return conv2d_same_reference(x, w)


conv2d_same_fwd_op.register_kernel("cuda")(_launch_fwd)


@conv2d_same_fwd_op.register_fake
def _conv2d_same_fwd_fake(x, w):
    return x.new_empty(tuple(x.shape[:3]) + (w.shape[3],))


conv2d_same_fwd.last_launch = None


def bwdw_plan(n, height, width, c, f, k, dtype, sms=H100_SMS):
    """K8's path and split for x [n, height, width, c] of ``dtype`` and
    k x k taps on a card of ``sms`` SMs, from the shapes and dtype alone:
    ``path`` ("tc_bf16" or
    "simt_f32"), the block tile, ``splits`` S contiguous ranges of
    ``positions_per_split`` positions (a multiple of the path's chunk;
    split s sums positions [s * per, min(P, (s + 1) * per)), every range
    non-empty, P = n * height * width), and ``workspace`` (float32 entries
    of the partials, S * k*k*c * f, or 0 when S = 1 writes dW directly)."""
    enforce(dtype in _BWDW_PATHS, "conv2d_same_bwd_filter takes float32 or "
            "bfloat16 inputs, got %s", dtype)
    cfg = _BWDW_PATHS[dtype]
    positions = n * height * width
    rows = k * k * c
    cols = 128 if cfg["path"] == "tc_bf16" and f >= 128 else 64
    tiles = -(-rows // _ROWS_PER_TILE) * -(-f // cols)
    want = max(1, min(-(-cfg["target_blocks_per_sm"] * sms // tiles),
                      positions // cfg["min_positions"]))
    chunk = cfg["chunk"]
    per = -(-(-(-positions // want)) // chunk) * chunk
    splits = -(-positions // per)
    return {"path": cfg["path"], "rows_per_tile": _ROWS_PER_TILE,
            "filters_per_tile": cols,
            "positions_per_chunk": chunk, "splits": splits,
            "positions_per_split": per,
            "workspace": splits * rows * f if splits > 1 else 0}


def bwdw_splits(n, height, width, c, f, k, dtype=torch.float32):
    """How many contiguous position ranges K8 splits its reduction into
    (``bwdw_plan``'s ``splits``)."""
    return bwdw_plan(n, height, width, c, f, k, dtype)["splits"]


def conv2d_same_bwd_filter(x, dy, k):
    """K8: the filter gradient dw [k, k, C, F] (float32) of the stride-1
    SAME conv from x [N, H, W, C] and dy [N, H, W, F] (see module
    docstring). After a kernel call, ``conv2d_same_bwd_filter.last_launch``
    holds the plan (``bwdw_plan``: path and split) and the grid."""
    enforce(dy.dim() == 4, "conv2d_same_bwd_filter: dy must be [N, H, W, F],"
            " got %s", tuple(dy.shape))
    f = dy.shape[3]
    _check("conv2d_same_bwd_filter", x, (k, k, x.shape[3], f),
           ("dy", dy, tuple(x.shape[:3]) + (f,)))
    dev = x.device
    if dev.type == "cpu":
        return conv2d_same_bwd_filter_reference(x, dy, k)
    enforce(dev.type == "cuda", "conv2d_same_bwd_filter runs on cuda or cpu "
            "tensors, got %s", dev)
    n, height, width, c = x.shape
    plan = bwdw_plan(n, height, width, c, f, k, x.dtype, sm_count(dev))
    dw = torch.empty((k, k, c, f), dtype=torch.float32, device=dev)
    ws = torch.empty((plan["workspace"],), dtype=torch.float32, device=dev)
    info = launch("conv2d_same_bwdw", dev,
                  (aligned(x), aligned(dy)), (dw, ws),
                  (n, height, width, c, f, k,
                   _BWDW_PATHS[x.dtype]["code"], plan["filters_per_tile"],
                   plan["splits"], plan["positions_per_split"]),
                  _count_bwdw_launches)
    conv2d_same_bwd_filter.last_launch = dict(plan, **dict(zip(
        ("filter_tiles", "row_tiles", "grid_splits", "grid_positions",
         "smem_bytes", "launches"), info)))
    return dw


conv2d_same_bwd_filter.last_launch = None


def transposed_weight(w):
    """w[::-1, ::-1].transpose(C, F): the weight whose stride-1 SAME conv
    with dy is the data gradient (pallas_conv.py:300)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


class ConvSame(torch.autograd.Function):
    """Differentiable stride-1 SAME conv, x [N, H, W, C] NHWC and w
    [k, k, C, F] HWIO -> [N, H, W, F], as pallas_conv.py ``_conv_p``.
    Forward and backward are the kernel wrappers, on either device."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv2d_same_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_same_fwd(dy, transposed_weight(w))
        if ctx.needs_input_grad[1]:
            dw = conv2d_same_bwd_filter(x, dy, w.shape[0]).to(w.dtype)
        return dx, dw


conv_same = ConvSame.apply
