"""The conv, pool and batch-norm ops of the port against the JAX package's,
on the CPU, with inputs made by numpy from a seed.

- K7 (``conv2d_same_fwd``) and ``ConvSame``: the plain version and the
  autograd Function (whose backward is K7 on the flipped, transposed
  weight for dx and K8 for dw, through their plain versions here) against
  ``lax.conv_general_dilated`` at full precision, and against the Pallas
  kernels (``pallas_conv.conv2d_lane_packed``, in interpret mode) where
  the JAX package's own predicate takes the shape: the hot shapes of
  tests/test_pallas_conv.py, odd widths (5, 9) and C = F = 8. float32
  within 1e-5 relative to max(1, the largest |value|) (the sums run in
  another order; these inputs show at most 5e-7); bfloat16 within 1e-2
  relative (one rounding of the output to bfloat16 is 2^-8 = 3.9e-3; the
  rest is the order of the float32 sums).
- K8's plain version against ``pallas_conv._bwd_filter_impl``.
- ``conv2d`` outside the family (the 7x7/s2 stem, the stride-2 1x1)
  against ``ops.conv.conv2d`` of the JAX package, forward and gradients.
- ``max_pool2d`` / ``avg_pool2d`` against the JAX package's, with the
  reference's ceil-mode geometry (16 -> 9 with 3x3/s2/p1), forward and
  gradients.
- ``batch_norm_train`` / ``batch_norm_infer`` against the JAX package's:
  outputs, moving statistics and gradients.
- The layers ``img_pool`` (max and average, stride 1 and 2, padding 0
  and 1, ``ceil_mode`` on and off, average with and without
  ``exclude_mode``) and ``img_conv`` at stride 2 (odd and even sizes,
  filters 1, 3 and 5) through both packages' topologies from the same
  numpy parameters: output geometry, outputs and gradients (of the input
  and of every parameter) within 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from paddle_tpu import activation as JA
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as JL
from paddle_tpu import pooling as jpool
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.ops import conv as jax_conv
from paddle_tpu.ops import pallas_conv as pc
from paddle_tpu.topology import Topology as JaxTopology

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type as dt
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import pooling as pool
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.topology import Topology

TOL_F32 = 1e-5
TOL_BF16 = 1e-2

# (k, C, F, H, W): the hot shapes of tests/test_pallas_conv.py, odd
# widths, and the narrowest channels the family takes
SHAPES = [
    (3, 64, 64, 6, 6),
    (1, 64, 256, 4, 6),
    (1, 256, 64, 4, 4),
    (3, 128, 128, 5, 5),
    (1, 128, 512, 4, 4),
    (1, 512, 128, 4, 4),
    (3, 16, 24, 5, 9),
    (1, 64, 32, 9, 5),
    (3, 8, 8, 7, 5),
    (1, 8, 8, 3, 9),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The Pallas kernels in interpret mode, as tests/test_pallas_conv.py
    runs them on the CPU."""
    monkeypatch.setattr(pc, "_INTERPRET", True)


def _inputs(k, c, f, h, w, seed=0):
    rng = np.random.RandomState(seed + 10 * k + c + f)
    x = (rng.randn(2, h, w, c) * 0.5).astype(np.float32)
    wk = (rng.randn(k, k, c, f) / np.sqrt(k * k * c)).astype(np.float32)
    sel = rng.randn(2, h, w, f).astype(np.float32)
    return x, wk, sel


def _lax_conv(x, wk):
    k = wk.shape[0]
    return lax.conv_general_dilated(
        x, wk, window_strides=(1, 1),
        padding=((k // 2, k // 2), (k // 2, k // 2)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST)


def _pallas_takes(x, wk):
    return pc.kernel_supported(x.shape, wk.shape, (1, 1), "SAME", 1, (1, 1),
                               jnp.float32)


def _np64(a):
    if torch.is_tensor(a):
        a = a.detach().float().numpy()
    return np.asarray(a, np.float64)


def _rel_err(got, want):
    got, want = _np64(got), _np64(want)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("k,c,f,h,w", SHAPES)
def test_forward_matches_lax_and_pallas(k, c, f, h, w):
    x, wk, _ = _inputs(k, c, f, h, w)
    want = np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(wk)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(wk)
    plain = ck.conv2d_same_reference(tx, tw)
    through = ck.conv_same(tx, tw)
    assert plain.shape == (2, h, w, f) and plain.dtype == torch.float32
    assert _rel_err(plain, want) <= TOL_F32
    assert torch.equal(through, plain)
    if _pallas_takes(x, wk):
        packed = pc.conv2d_lane_packed(jnp.asarray(x), jnp.asarray(wk))
        assert _rel_err(plain, packed) <= TOL_F32


@pytest.mark.parametrize("k,c,f,h,w", SHAPES)
def test_gradients_match_lax_and_pallas(k, c, f, h, w):
    """dx (K7 on the transposed weight) and dw (K8) of ConvSame against
    the autodiff of the lax conv and the Pallas custom VJP."""
    x, wk, sel = _inputs(k, c, f, h, w, seed=3)

    def loss(fn, a, b):
        return jnp.sum(fn(a, b) * sel)

    refs = [jax.grad(lambda a, b: loss(_lax_conv, a, b),
                     argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))]
    if _pallas_takes(x, wk):
        refs.append(jax.grad(lambda a, b: loss(pc.conv2d_lane_packed, a, b),
                             argnums=(0, 1))(jnp.asarray(x),
                                             jnp.asarray(wk)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wk).requires_grad_()
    (ck.conv_same(tx, tw) * torch.from_numpy(sel)).sum().backward()
    for gx, gw in refs:
        assert _rel_err(tx.grad, gx) <= TOL_F32
        assert _rel_err(tw.grad, gw) <= TOL_F32


@pytest.mark.parametrize("k,c,f,h,w", SHAPES[::3])
def test_bfloat16_forward_and_gradients_track_lax(k, c, f, h, w):
    """bfloat16 x and w: y, dx and dw in bfloat16 against the lax conv of
    the same bfloat16 values in float32."""
    x, wk, sel = _inputs(k, c, f, h, w, seed=5)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(wk).bfloat16()
    x32, w32 = xb.float().numpy(), wb.float().numpy()
    want = _lax_conv(jnp.asarray(x32), jnp.asarray(w32))
    gx, gw = jax.grad(lambda a, b: jnp.sum(_lax_conv(a, b) * sel),
                      argnums=(0, 1))(jnp.asarray(x32), jnp.asarray(w32))
    tx, tw = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    y = ck.conv_same(tx, tw)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(sel)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert _rel_err(y, want) <= TOL_BF16
    assert _rel_err(tx.grad, gx) <= TOL_BF16
    assert _rel_err(tw.grad, gw) <= TOL_BF16


@pytest.mark.parametrize("k,c,f,h,w", SHAPES)
def test_bwd_filter_plain_version_matches_pallas(k, c, f, h, w):
    x, _, dy = _inputs(k, c, f, h, w, seed=7)
    want = pc._bwd_filter_impl(jnp.asarray(x), jnp.asarray(dy), k, k)
    got = ck.conv2d_same_bwd_filter_reference(torch.from_numpy(x),
                                              torch.from_numpy(dy), k)
    assert got.shape == (k, k, c, f) and got.dtype == torch.float32
    assert _rel_err(got, want) <= TOL_F32


@pytest.mark.parametrize("fsize,stride,pad,c,f,h", [
    (7, 2, 3, 3, 16, 16),    # the ResNet stem
    (1, 2, 0, 16, 32, 9),    # a stage head's stride-2 1x1
    (3, 2, 1, 8, 8, 7),      # a strided 3x3 (basic blocks)
    (5, 1, 2, 8, 16, 6),     # 5x5: outside the family
])
def test_conv2d_outside_the_family_matches_jax(fsize, stride, pad, c, f, h):
    rng = np.random.RandomState(fsize + c + h)
    x = (rng.randn(2, h, h, c) * 0.5).astype(np.float32)
    wk = (rng.randn(fsize, fsize, c, f) / np.sqrt(fsize * fsize * c)
          ).astype(np.float32)
    pads = ((pad, pad), (pad, pad))
    assert not ck.kernel_supported(x.shape, wk.shape, (stride, stride), pads,
                                   1, (1, 1), torch.float32, torch.float32)

    def jfn(a, b):
        return jax_conv.conv2d(a, b, stride=(stride, stride), padding=pads)

    want = jfn(jnp.asarray(x), jnp.asarray(wk))
    sel = rng.randn(*want.shape).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * sel),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wk).requires_grad_()
    y = conv_ops.conv2d(tx, tw, stride=(stride, stride), padding=pads)
    assert tuple(y.shape) == tuple(want.shape)
    (y * torch.from_numpy(sel)).sum().backward()
    assert _rel_err(y, want) <= TOL_F32
    assert _rel_err(tx.grad, gx) <= TOL_F32
    assert _rel_err(tw.grad, gw) <= TOL_F32


def test_conv2d_routes_the_family_to_the_kernels(monkeypatch):
    """A family conv goes through ConvSame (the K7 wrapper), including the
    1x1 C=64 conv at width 57 that the JAX predicate refuses for its lane
    fold; the stem does not."""
    calls = []
    plain = ck.conv2d_same_fwd
    monkeypatch.setattr(ck, "conv2d_same_fwd",
                        lambda x, w: calls.append(tuple(w.shape))
                        or plain(x, w))
    x = torch.randn(1, 57, 57, 64)
    w = torch.randn(1, 1, 64, 16)
    assert not pc.kernel_supported(x.shape, w.shape, (1, 1), "SAME", 1,
                                   (1, 1), jnp.float32)
    conv_ops.conv2d(x, w, padding=((0, 0), (0, 0)))
    conv_ops.conv2d(torch.randn(1, 16, 16, 3), torch.randn(7, 7, 3, 8),
                    stride=(2, 2), padding=((3, 3), (3, 3)))
    assert calls == [(1, 1, 64, 16)]


@pytest.mark.parametrize("stride,padding,groups,dilation,dtypes,expect", [
    ((1, 1), ((1, 1), (1, 1)), 1, (1, 1), ("f32", "f32"), True),
    ((2, 2), ((1, 1), (1, 1)), 1, (1, 1), ("f32", "f32"), False),
    ((1, 1), ((0, 0), (0, 0)), 1, (1, 1), ("f32", "f32"), False),
    ((1, 1), ((1, 1), (1, 1)), 2, (1, 1), ("f32", "f32"), False),
    ((1, 1), ((1, 1), (1, 1)), 1, (2, 2), ("f32", "f32"), False),
    ((1, 1), ((1, 1), (1, 1)), 1, (1, 1), ("bf16", "bf16"), True),
    ((1, 1), ((1, 1), (1, 1)), 1, (1, 1), ("bf16", "f32"), False),
    ((1, 1), ((1, 1), (1, 1)), 1, (1, 1), ("f16", "f16"), False),
])
def test_kernel_supported_is_the_function_family(stride, padding, groups,
                                                 dilation, dtypes, expect):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}
    assert ck.kernel_supported((2, 5, 5, 16), (3, 3, 16, 24), stride,
                               padding, groups, dilation, dt[dtypes[0]],
                               dt[dtypes[1]]) is expect


@pytest.mark.parametrize("w_shape", [(5, 5, 16, 24), (3, 3, 12, 24),
                                     (3, 3, 16, 20), (2, 2, 16, 24)])
def test_kernel_supported_refuses_other_kernels_and_widths(w_shape):
    pad = w_shape[0] // 2
    assert not ck.kernel_supported((2, 5, 5, w_shape[2]), w_shape, (1, 1),
                                   ((pad, pad), (pad, pad)), 1, (1, 1),
                                   torch.float32, torch.float32)


@pytest.mark.parametrize("kind,size,window,stride,pad", [
    ("max", 16, 3, 2, 1),   # the ResNet stem pool geometry: 16 -> 9
    ("max", 112, 3, 2, 1),  # at 224: 112 -> 57
    ("max", 7, 2, 2, 0),
    ("avg", 16, 3, 2, 1),
    ("avg", 8, 8, 1, 0),    # ResNet's global average pool
    ("avg", 9, 3, 3, 1),
])
def test_pools_match_jax_with_ceil_geometry(kind, size, window, stride, pad):
    rng = np.random.RandomState(size + window)
    x = rng.randn(2, size, size, 8).astype(np.float32)
    out = -(-(size + 2 * pad - window) // stride) + 1
    jfn = jax_conv.max_pool2d if kind == "max" else jax_conv.avg_pool2d
    fn = conv_ops.max_pool2d if kind == "max" else conv_ops.avg_pool2d
    args = ((window, window), (stride, stride), (pad, pad), True)

    def jpool(a):
        return jfn(a, *args)[:, :out, :out, :]

    want = jpool(jnp.asarray(x))
    sel = rng.randn(*want.shape).astype(np.float32)
    gx = jax.grad(lambda a: jnp.sum(jpool(a) * sel))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = fn(tx, *args)[:, :out, :out, :]
    assert tuple(y.shape) == (2, out, out, 8)
    (y * torch.from_numpy(sel)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-6,
                               atol=1e-6)
    if size == 112:
        assert out == 57


@pytest.mark.parametrize("shape,axes", [((4, 5, 5, 16), (0, 1, 2)),
                                        ((6, 12), (0,))])
def test_batch_norm_matches_jax(shape, axes):
    """Train mode: y, the moving statistics (momentum 0.9, biased variance
    mean(x^2) - mean^2) and the gradients of x, gamma and beta; test mode:
    y from the moving statistics."""
    rng = np.random.RandomState(len(shape))
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.3 * rng.randn(c)).astype(np.float32)
    mm = (0.2 * rng.randn(c)).astype(np.float32)
    mv = (1 + rng.rand(c)).astype(np.float32)
    sel = rng.randn(*shape).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, gamma, beta, mm, mv)]
    want, jmean, jvar = jax_conv.batch_norm_train(*j, axes, 0.9, 1e-5)
    grads = jax.grad(lambda a, g, b: jnp.sum(jax_conv.batch_norm_train(
        a, g, b, j[3], j[4], axes, 0.9, 1e-5)[0] * sel),
        argnums=(0, 1, 2))(*j[:3])
    t = [torch.from_numpy(a) for a in (x, gamma, beta, mm, mv)]
    for a in t[:3]:
        a.requires_grad_()
    y, mean, var = conv_ops.batch_norm_train(*t, axes, 0.9, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    (y * torch.from_numpy(sel)).sum().backward()
    for got, ref in ((y.detach(), want), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    for got, ref in zip(t[:3], grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    infer = conv_ops.batch_norm_infer(*[a.detach() for a in t], 1e-5)
    np.testing.assert_allclose(
        infer.numpy(), np.asarray(jax_conv.batch_norm_infer(*j, 1e-5)),
        rtol=1e-5, atol=1e-5)


def test_out_size_and_pool_pads_match_jax():
    for args in [(224, 7, 2, 3), (57, 1, 2, 0), (29, 3, 1, 1),
                 (15, 1, 2, 0)]:
        for caffe in (True, False):
            assert conv_ops.out_size(*args, caffe_mode=caffe) == \
                jax_conv.out_size(*args, caffe_mode=caffe)
    for size, window, stride, pad in [(112, 3, 2, 1), (16, 3, 2, 1),
                                      (8, 8, 1, 0), (7, 2, 2, 0)]:
        for ceil in (True, False):
            want = jax_conv._pool_pads(np.zeros((1, size, size, 1)),
                                       (window, window), (stride, stride),
                                       (pad, pad), ceil)
            assert conv_ops._pool_pads((size, size), (window, window),
                                       (stride, stride), (pad, pad),
                                       ceil) == want


# ResNet-50's stride-1 convs (k, C, F, H=W), as chip_smoke.py's RESNET_CONVS
RESNET_STRIDE1 = [(1, 64, 64, 57), (3, 64, 64, 57), (1, 64, 256, 57),
                  (1, 256, 64, 57), (3, 128, 128, 29), (1, 128, 512, 29),
                  (1, 512, 128, 29), (3, 256, 256, 15), (1, 256, 1024, 15),
                  (1, 1024, 256, 15), (3, 512, 512, 8), (1, 512, 2048, 8),
                  (1, 2048, 512, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c,f,hw", RESNET_STRIDE1 + [(3, 8, 8, 5)])
def test_bwdw_plan_covers_every_position_once(dtype, k, c, f, hw):
    """K8's planner at batch 64: the tensor-core path for bfloat16, the
    CUDA cores for float32; S ranges of a whole number of chunks partition
    the N*H*W positions, none empty; the workspace holds exactly S partial
    dW tiles (none when S = 1)."""
    n = 64
    plan = ck.bwdw_plan(n, hw, hw, c, f, k, dtype)
    assert plan == ck.bwdw_plan(n, hw, hw, c, f, k, dtype)
    assert plan["path"] == ("tc_bf16" if dtype == torch.bfloat16
                            else "simt_f32")
    positions = n * hw * hw
    per, s = plan["positions_per_split"], plan["splits"]
    assert per % plan["positions_per_chunk"] == 0
    assert (s - 1) * per < positions <= s * per
    assert plan["workspace"] == (s * k * k * c * f if s > 1 else 0)
    assert ck.bwdw_splits(n, hw, hw, c, f, k, dtype) == s
    cols = plan["filters_per_tile"]
    assert cols == (128 if dtype == torch.bfloat16 and f >= 128 else 64)
    tiles = -(-k * k * c // 128) * -(-f // cols)
    assert s == 1 or tiles * s <= (4 if dtype == torch.float32 else 2) * 132 \
        + tiles


def test_bwdw_plan_refuses_other_dtypes():
    with pytest.raises(Exception, match="float32 or bfloat16"):
        ck.bwdw_plan(1, 4, 4, 8, 8, 3, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c,f,hw", RESNET_STRIDE1 + [(3, 8, 8, 5)])
def test_fwd_plan_at_resnet50_shapes(dtype, k, c, f, hw):
    """K7's planner at batch 64, for the forward (F outputs) and the data
    gradient (C outputs): the tensor-core path for bfloat16 in 128-position
    tiles, 128 filters only where F >= 128 and the grid keeps two blocks
    per SM; the CUDA cores for float32 in 64 filters, 64-position tiles
    where 128 would give fewer than four blocks per SM."""
    n = 64
    positions = n * hw * hw
    for cols in (f, c):
        plan = ck.fwd_plan(n, hw, hw, cols, dtype)
        assert plan == ck.fwd_plan(n, hw, hw, cols, dtype)

        def blocks(rows, filters):
            return -(-positions // rows) * -(-cols // filters)

        if dtype == torch.bfloat16:
            assert plan["path"] == "tc_bf16"
            assert plan["positions_per_tile"] == 128
            wide = cols >= 128 and blocks(128, 128) >= 2 * 132
            assert plan["filters_per_tile"] == (128 if wide else 64)
        else:
            assert plan["path"] == "simt_f32"
            assert plan["filters_per_tile"] == 64
            assert plan["positions_per_tile"] == (
                128 if blocks(128, 64) >= 4 * 132 else 64)
    # the stage-2 convs of 57 x 57 keep 128-position tiles in both dtypes;
    # stage 4's 3x3 at 8 x 8 is small enough for 64-filter (bf16) and
    # 64-position (f32) tiles
    if hw == 57:
        assert ck.fwd_plan(n, hw, hw, f, dtype)["positions_per_tile"] == 128
    if (k, c, f, hw) == (3, 512, 512, 8):
        plan = ck.fwd_plan(n, hw, hw, f, dtype)
        assert (plan["positions_per_tile"], plan["filters_per_tile"]) == \
            ((128, 64) if dtype == torch.bfloat16 else (64, 64))


@pytest.mark.parametrize("sms", [60, 114, 264])
def test_conv_plans_follow_the_cards_sm_count(sms):
    """K7's and K8's planners size their grids by the card's SM count: at
    60 SMs stage 4's 3x3 (8 x 8, batch 64) keeps 128-filter
    (bf16) and 128-position (f32) tiles, as K7's rule gives for that count;
    K8's split keeps about its blocks per SM."""
    n, hw, k, c, f = 64, 8, 3, 512, 512
    positions = n * hw * hw
    bf = ck.fwd_plan(n, hw, hw, f, torch.bfloat16, sms)
    f32 = ck.fwd_plan(n, hw, hw, f, torch.float32, sms)
    assert bf["filters_per_tile"] == (
        128 if -(-positions // 128) * -(-f // 128) >= 2 * sms else 64)
    assert f32["positions_per_tile"] == (
        128 if -(-positions // 128) * -(-f // 64) >= 4 * sms else 64)
    if sms == 60:
        assert (bf["filters_per_tile"], f32["positions_per_tile"]) == \
            (128, 128)
    for dtype, per_sm in ((torch.float32, 4), (torch.bfloat16, 2)):
        plan = ck.bwdw_plan(n, 15, 15, 256, 256, 3, dtype, sms)
        tiles = -(-9 * 256 // 128) * -(-256 // plan["filters_per_tile"])
        assert plan["splits"] == 1 or \
            tiles * plan["splits"] <= per_sm * sms + tiles


def test_fwd_plan_refuses_other_dtypes():
    with pytest.raises(Exception, match="float32 or bfloat16"):
        ck.fwd_plan(1, 4, 4, 8, torch.float16)


# -- img_pool and img_conv at the layer level --------------------------------

def _layer_pair(build, c, size):
    """(port topology, JAX topology, output names) of ``build(layer, dt,
    activation, pooling, image)`` over a c x size x size image."""
    reset_name_counters()
    img = L.data(name="image", type=dt.dense_vector(c * size * size),
                 height=size, width=size)
    out = build(L, A, pool, img)
    jax_reset_names()
    jimg = JL.data(name="image", type=jdt.dense_vector(c * size * size),
                   height=size, width=size)
    jout = build(JL, JA, jpool, jimg)
    assert out.out_img_shape == jout.out_img_shape
    assert out.size == jout.size
    return Topology(out), JaxTopology(jout), out.name, jout.name


def _layer_parity(topo, jtopo, name, jname, c, size, seed):
    """Forward and the gradients (input and every parameter) of
    sum(out * sel) through both packages, from the same numpy values."""
    rng = np.random.RandomState(seed)
    arrays = {n: (rng.randn(*spec.shape) * 0.3).astype(np.float32)
              for n, spec in sorted(topo.param_specs().items())}
    assert sorted(arrays) == sorted(jtopo.param_specs())
    x = rng.randn(2, c * size * size).astype(np.float32)
    params = {n: torch.from_numpy(v.copy()).requires_grad_()
              for n, v in arrays.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y = topo.apply(params, {"image": tx}, mode="train")[0][name]
    sel = rng.randn(*y.shape).astype(np.float32)
    (y * torch.from_numpy(sel)).sum().backward()

    def jfn(p, a):
        values, _ = jtopo.apply(p, {"image": a}, mode="test")
        return jnp.sum(values[jname] * sel), values[jname]

    (_, want), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1),
                                               has_aux=True)(
        {n: jnp.asarray(v) for n, v in arrays.items()}, jnp.asarray(x))
    assert tuple(y.shape) == tuple(want.shape)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL_F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=TOL_F32)
    for n, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[n]),
                                   rtol=0, atol=TOL_F32, err_msg=n)


POOL_CASES = ([("max", s, p, ceil, True) for s in (1, 2) for p in (0, 1)
               for ceil in (True, False)]
              + [("avg", s, p, ceil, excl) for s in (1, 2) for p in (0, 1)
                 for ceil in (True, False) for excl in (True, False)])


@pytest.mark.parametrize("kind,stride,pad,ceil,exclude", POOL_CASES)
def test_img_pool_layer_matches_jax(kind, stride, pad, ceil, exclude):
    c, size, window = 3, 8, 3

    def build(layer, act, pooling, img):
        ptype = (pooling.MaxPooling() if kind == "max"
                 else pooling.AvgPooling())
        return layer.img_pool(input=img, pool_size=window, stride=stride,
                              padding=pad, pool_type=ptype, ceil_mode=ceil,
                              exclude_mode=exclude, name="pool")

    topo, jtopo, name, jname = _layer_pair(build, c, size)
    floor = (size + 2 * pad - window) // stride + 1
    ceiled = -(-(size + 2 * pad - window) // stride) + 1
    assert topo.by_name[name].out_img_shape[1] == (ceiled if ceil
                                                   else floor)
    _layer_parity(topo, jtopo, name, jname, c, size, seed=stride + pad)


@pytest.mark.parametrize("fsize,pad,size", [(3, 1, 7), (3, 0, 8),
                                            (1, 0, 7), (5, 2, 9)])
def test_img_conv_layer_at_stride_2_matches_jax(fsize, pad, size):
    c, f = 3, 4

    def build(layer, act, pooling, img):
        return layer.img_conv(input=img, filter_size=fsize, num_filters=f,
                              stride=2, padding=pad, act=act.Relu(),
                              name="conv")

    topo, jtopo, name, jname = _layer_pair(build, c, size)
    assert topo.by_name[name].out_img_shape == (
        f, (size + 2 * pad - fsize) // 2 + 1,
        (size + 2 * pad - fsize) // 2 + 1)
    _layer_parity(topo, jtopo, name, jname, c, size, seed=fsize + size)
