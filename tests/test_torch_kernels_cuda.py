"""The hand-written LSTM, GRU, convolution and int8 matmul kernels,
forward and backward, against their plain versions ON THE CARD.

Needs an NVIDIA card and nvcc; skips with a reason elsewhere. This file
imports neither JAX nor paddle_tpu, so it also runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.ops import int8_kernels as ik
from paddle_tpu_torch.ops import lstm_kernels as lk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode "
                    "(tests/test_torch_lstm.py, test_torch_lstm_bwd.py, "
                    "test_torch_gru.py, test_torch_conv.py and "
                    "test_torch_int8.py cover their plain versions)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch,hidden", [(3, 40), (8, 256), (64, 1280),
                                          (128, 1280), (600, 256)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol,
                                              batch, hidden):
    """The hand-written kernel against its plain version on the card; the
    tolerance covers the different summation order (and, in bfloat16, one
    flipped rounding of h feeding through the recurrence). The last two
    shapes need more blocks than one co-resident grid holds, so the
    wrapper runs them as several launches of row chunks."""
    rng = np.random.RandomState(hidden + batch)
    steps = 20
    lens = rng.randint(0, steps + 1, batch)
    lens[0] = steps

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=cuda_device)

    args = (dev(rng.randn(steps, batch, 4 * hidden) * 0.5),
            dev((np.arange(steps)[:, None] < lens[None, :]), torch.float32),
            dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(3, hidden) * 0.3, torch.float32),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))
    before = lk.launches
    h_k, c_k = lk.lstm_seq_fwd(*args)
    torch.cuda.synchronize()
    assert lk.launches == before + lk.lstm_seq_fwd.last_launch["launches"]
    if batch <= 64:
        assert lk.lstm_seq_fwd.last_launch["launches"] == 1
    if hidden == 1280 and batch == 128:
        # 40 unit tiles x 16 row tiles of 8 > 3 blocks per SM x 132 SMs
        assert lk.lstm_seq_fwd.last_launch["launches"] >= 2
    h_r, c_r = lk.lstm_seq_fwd_reference(*args)
    torch.testing.assert_close(h_k.float(), h_r.float(), rtol=0, atol=tol)
    torch.testing.assert_close(c_k.float(), c_r.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch", [1, 3, 8, 64, 128])
@pytest.mark.parametrize("hidden", [40, 256, 1280])
def test_bwd_kernel_matches_plain_version_on_card(cuda_device, dtype, tol,
                                                  batch, hidden):
    """The backward kernel against its plain version on the card, with
    ragged masks (lengths T, 0, 1 and random): dgates, dh0, dc0 absolute,
    dpeep (a sum over B and T) relative to its size. The tolerance covers
    the different summation order of both GEMVs (and, in bfloat16, a
    flipped rounding of dz feeding through the dh carry). The layout is
    ``bwd_plan``'s: unit tiles at H=40 and 256, W tiles at H=1280 (resident
    in bfloat16, streamed from L2 in float32), where B=128 runs as two
    launches of 64 rows. A repeat is bit-identical (partial sums in a fixed
    order, no atomics)."""
    rng = np.random.RandomState(hidden + batch)
    steps = 20
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=cuda_device)

    seq = (steps, batch, hidden)
    args = (dev(rng.randn(steps, batch, 4 * hidden) * 0.5),
            dev((np.arange(steps)[:, None] < lens[None, :]), torch.float32),
            dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(3, hidden) * 0.3, torch.float32),
            dev(np.tanh(rng.randn(*seq))), dev(rng.randn(*seq) * 0.5),
            dev(rng.randn(*seq) * 0.5), dev(rng.randn(*seq) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))
    before = lk.bwd_launches
    got = lk.lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    launch = dict(lk.lstm_seq_bwd.last_launch)
    assert lk.bwd_launches == before + launch["launches"]
    if batch <= 64:
        assert launch["launches"] == 1, launch
    if hidden == 1280 and batch == 128:
        assert launch["launches"] == 2, launch
    plan = lk.bwd_plan(batch, hidden, dtype)
    assert launch["layout"] == plan["layout"] == (
        "w_tiles" if hidden == 1280 else "unit_tiles")
    if plan["layout"] == "w_tiles":
        assert plan["resident"] == (dtype == torch.bfloat16)
        assert launch["w_placement"] == (4 if plan["resident"] else 3)
        # (D) on the tensor cores in bfloat16 at more than 8 rows a launch
        assert launch["dh_path"] == ("tc_bf16" if dtype == torch.bfloat16
                                     and batch > 8 else "simt_f32")
    else:
        assert launch["w_placement"] in (0, 1, 2)
    want = lk.lstm_seq_bwd_reference(*args)
    for name, g, w in zip(("dgates", "dh0", "dc0"), got[:3], want[:3]):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    scale = float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=tol * scale,
                               msg=lambda m: "dpeep: %s" % m)
    again = lk.lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("hidden", [3200, 4096, 8192])
def test_bwd_kernel_at_wide_hidden_on_card(cuda_device, dtype, tol, batch,
                                           hidden):
    """The backward at widths where a W tile of 2 units per lane fits no
    row count (H=3200, 4096) and, in float32, where no W tile fits at all
    (H=8192: unit tiles): the planner's layout runs, agrees with the plain
    version (as test_bwd_kernel_matches_plain_version_on_card) and repeats
    bit for bit. Inputs from a seeded generator on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(hidden + batch)
    steps = 2

    def randn(*shape, scale=0.5, dt=dtype):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).to(dt)

    seq = (steps, batch, hidden)
    mask = torch.ones((steps, batch), device=cuda_device)
    mask[1, : batch // 2] = 0.0
    args = (randn(steps, batch, 4 * hidden), mask,
            randn(hidden, 4 * hidden, scale=hidden ** -0.5),
            randn(3, hidden, scale=0.3, dt=torch.float32),
            torch.tanh(randn(*seq, scale=1.0)), randn(*seq), randn(*seq),
            randn(*seq), randn(batch, hidden), randn(batch, hidden))
    plan = lk.bwd_plan(batch, hidden, dtype,
                       *lk.device_limits(cuda_device))
    got = lk.lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    launch = dict(lk.lstm_seq_bwd.last_launch)
    assert launch["layout"] == plan["layout"] == (
        "unit_tiles" if hidden == 8192 and dtype == torch.float32
        else "w_tiles"), launch
    want = lk.lstm_seq_bwd_reference(*args)
    for name, g, w in zip(("dgates", "dh0", "dc0"), got[:3], want[:3]):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    scale = float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=tol * scale,
                               msg=lambda m: "dpeep: %s" % m)
    again = lk.lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def _gru_inputs(rng, device, dtype, steps, batch, hidden):
    """Numpy-seeded GRU inputs; lengths include T, 0 and 1; the update and
    reset columns of w_rz drawn independently."""
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    return (dev(rng.randn(steps, batch, 3 * hidden) * 0.5),
            dev((np.arange(steps)[:, None] < lens[None, :]), torch.float32),
            dev(rng.randn(hidden, 2 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(hidden, hidden) / np.sqrt(hidden)),
            dev(rng.randn(batch, hidden) * 0.5))


# (B, H): odd widths (H not a multiple of 32, nor of 4), the tagger's
# served and trained batches, the NMT encoder width, a width whose W
# slices do not fit shared memory (W streams from L2), and a batch too
# large for one co-resident grid (several launches of row chunks)
GRU_SHAPES = [(3, 37), (8, 256), (64, 256), (64, 512), (4, 1024), (600, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch,hidden", GRU_SHAPES)
def test_gru_fwd_kernel_matches_plain_version_on_card(cuda_device, dtype,
                                                      tol, batch, hidden):
    """The GRU forward kernel against its plain version on the card; the
    tolerance covers the different summation order of both GEMVs (and, in
    bfloat16, one flipped rounding of r*h or h feeding through the
    recurrence)."""
    rng = np.random.RandomState(hidden + batch)
    args = _gru_inputs(rng, cuda_device, dtype, 20, batch, hidden)
    before = gk.launches
    h_k = gk.gru_seq_fwd(*args)
    torch.cuda.synchronize()
    launch = gk.gru_seq_fwd.last_launch
    assert gk.launches == before + launch["launches"]
    if batch <= 64:
        assert launch["launches"] == 1, launch
    if batch == 600:
        assert launch["launches"] >= 2, launch
    h_r = gk.gru_seq_fwd_reference(*args)
    assert h_k.dtype == dtype
    torch.testing.assert_close(h_k.float(), h_r.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch,hidden", GRU_SHAPES)
def test_gru_bwd_kernel_matches_plain_version_on_card(cuda_device, dtype,
                                                      tol, batch, hidden):
    """The GRU backward kernel against its plain version on the card:
    dproj and dh0, each relative to max(1, its largest |entry|). The
    tolerance covers the different summation order of the recompute and
    the two transposed GEMVs (and, in bfloat16, a flipped rounding of dz
    feeding through the dh carry)."""
    rng = np.random.RandomState(7 * batch + hidden)
    steps = 20
    proj, mask, w_rz, w_c, h0 = _gru_inputs(rng, cuda_device, dtype, steps,
                                            batch, hidden)
    h_seq = gk.gru_seq_fwd_reference(proj, mask, w_rz, w_c, h0)
    args = (proj, mask, w_rz, w_c, torch.cat([h0[None], h_seq[:-1]]),
            torch.tensor(rng.randn(steps, batch, hidden) * 0.5, dtype=dtype,
                         device=cuda_device),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=dtype,
                         device=cuda_device))
    before = gk.bwd_launches
    got = gk.gru_seq_bwd(*args)
    torch.cuda.synchronize()
    launch = gk.gru_seq_bwd.last_launch
    assert gk.bwd_launches == before + launch["launches"]
    if batch <= 64:
        assert launch["launches"] == 1, launch
    if batch == 600:
        assert launch["launches"] >= 2, launch
    want = gk.gru_seq_bwd_reference(*args)
    for name, g, w in zip(("dproj", "dh0"), got, want):
        assert g.dtype == dtype
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * scale,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))


# (N, H, W, C, F, k): ResNet-50 stage shapes at a small batch, N=1, the
# narrowest channels at odd sizes, a stage-4 3x3 at batch 64; and for K7's
# tiles: C=F=8 at 17x23 (one 16-byte bfloat16 copy is a whole tap), F=192
# (not a multiple of 128) in 128-filter tiles, and ResNet-50's widest 1x1
# at batch 64
CONV_SHAPES = [(2, 57, 57, 64, 64, 3), (2, 57, 57, 64, 256, 1),
               (2, 29, 29, 512, 128, 1), (1, 8, 8, 2048, 512, 1),
               (1, 15, 15, 256, 256, 3), (3, 7, 5, 8, 8, 3),
               (2, 9, 11, 8, 24, 1), (64, 15, 15, 256, 256, 3),
               (1, 57, 57, 64, 64, 3), (64, 17, 23, 8, 8, 3),
               (64, 29, 29, 128, 192, 1), (64, 8, 8, 512, 2048, 1)]


def _conv_inputs(device, dtype, n, h, w, c, f, k):
    rng = np.random.RandomState(n + h + c + f + k)

    def dev(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return (dev(rng.randn(n, h, w, c) * 0.5),
            dev(rng.randn(k, k, c, f) / np.sqrt(k * k * c)),
            dev(rng.randn(n, h, w, f) * 0.5))


def _rel_err(got, want):
    return (float((got.float() - want.float()).abs().max())
            / max(1.0, float(want.float().abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,h,w,c,f,k", CONV_SHAPES)
def test_conv_kernels_match_plain_versions_on_card(cuda_device, dtype, tol,
                                                   n, h, w, c, f, k):
    """K7 forward, K7 on the flipped, transposed weight (the data
    gradient) and K8 (the filter gradient) against their plain versions on
    the card, each relative to max(1, its largest |entry|). Both sum in
    float32 in another order; in bfloat16 the output's one rounding can
    land one bfloat16 step apart (2^-8 = 3.9e-3 relative). K8's output is
    float32 in both cases: 1e-4. K7 runs the path and tile of
    ``fwd_plan`` (tensor cores in bfloat16, CUDA cores in float32), and a
    repeat of each K7 call is bit-identical (no split of K, no atomics)."""
    x, wk, dy = _conv_inputs(cuda_device, dtype, n, h, w, c, f, k)
    before = (ck.launches, ck.bwdw_launches)
    y = ck.conv2d_same_fwd(x, wk)
    w_t = ck.transposed_weight(wk)
    dx = ck.conv2d_same_fwd(dy, w_t)
    dw = ck.conv2d_same_bwd_filter(x, dy, k)
    torch.cuda.synchronize()
    assert (ck.launches, ck.bwdw_launches) == (before[0] + 2, before[1] + 1)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    assert ck.conv2d_same_bwd_filter.last_launch["grid_splits"] == \
        ck.bwdw_splits(n, h, w, c, f, k, dtype)
    assert _rel_err(y, ck.conv2d_same_reference(x, wk)) <= tol
    assert _rel_err(dx, ck.conv2d_same_reference(dy, w_t)) <= tol
    assert _rel_err(dw, ck.conv2d_same_bwd_filter_reference(x, dy, k)) \
        <= 1e-4
    for out, inp, weight, cols in ((y, x, wk, f), (dx, dy, w_t, c)):
        assert torch.equal(ck.conv2d_same_fwd(inp, weight), out)
        torch.cuda.synchronize()
        launch = ck.conv2d_same_fwd.last_launch
        plan = ck.fwd_plan(n, h, w, cols, dtype)
        assert launch["path"] == plan["path"] == (
            "tc_bf16" if dtype == torch.bfloat16 else "simt_f32")
        assert (launch["grid_positions_per_tile"],
                launch["grid_filters_per_tile"]) == (
            plan["positions_per_tile"], plan["filters_per_tile"])


@pytest.mark.cuda
def test_conv_same_backward_runs_the_kernels_on_card(cuda_device):
    """ConvSame on the card: one K7 launch forward, one K7 and one K8
    launch backward, and the gradients of its plain versions."""
    x, wk, dy = _conv_inputs(cuda_device, torch.float32, 2, 9, 9, 32, 64, 3)
    xg, wg = x.clone().requires_grad_(), wk.clone().requires_grad_()
    ck.reset_launches()
    ck.conv_same(xg, wg).backward(dy)
    torch.cuda.synchronize()
    assert (ck.launches, ck.bwdw_launches) == (2, 1)
    xr, wr = x.clone().requires_grad_(), wk.clone().requires_grad_()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = (torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2),
                                          wr.permute(3, 2, 0, 1), padding=1)
               .permute(0, 2, 3, 1))
        ref.backward(dy)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert _rel_err(xg.grad, xr.grad) <= 1e-4
    assert _rel_err(wg.grad, wr.grad) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,k,n", [(2048, 256, 1024), (1, 2048, 1000),
                                   (32, 256, 2), (3, 37, 129)])
def test_int8_matmul_kernel_matches_plain_version_on_card(cuda_device, dtype,
                                                          tol, m, k, n):
    """K9 against its plain version on the card, divided by max(1, max
    |plain|): float32 sums in another order; bfloat16 rounds the float32 sum
    once, and the two roundings can land one bfloat16 step apart. The
    shapes take the 16-byte, 8-byte and byte weight loads, and ragged K, M
    and N edges."""
    rng = np.random.RandomState(m + k + n)
    w = rng.randn(k, n) / np.sqrt(k)
    scale = np.abs(w).max(0) / 127.0
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    x = torch.tensor(rng.randn(m, k), dtype=dtype, device=cuda_device)
    w_q = torch.tensor(w_q, device=cuda_device)
    scale = torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    before = ik.launches
    y = ik.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert ik.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    want = ik.int8_matmul_reference(x, w_q, scale)
    err = (y.float() - want.float()).abs().max().item()
    assert err / max(1.0, want.float().abs().max().item()) <= tol
    # lead dimensions flatten into one launch
    y3 = ik.int8_matmul(x.reshape(1, m, k), w_q, scale)
    assert ik.launches == before + 2 and torch.equal(y3[0], y)


def _int8_case(device, dtype, m, k, n):
    rng = np.random.RandomState(m + k + n)
    w = rng.randn(k, n) / np.sqrt(k)
    scale = np.abs(w).max(0) / 127.0
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return (torch.tensor(rng.randn(m, k), dtype=dtype, device=device),
            torch.tensor(w_q, device=device),
            torch.tensor(scale, dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n", [2, 129, 1000])
@pytest.mark.parametrize("k", [37, 2048])
@pytest.mark.parametrize("m", [1, 3, 33, 2048])
def test_int8_matmul_paths_at_awkward_shapes_on_card(cuda_device, dtype, tol,
                                                     m, k, n):
    """Each of K9's three paths (split-K for M <= 32, the tensor cores for
    bfloat16 and the CUDA cores for float32 above) at ragged M, K and N,
    against the plain version (as above), one launch per call, and a
    repeat that is bit-identical (split-K sums its partials in a fixed
    order, no atomics)."""
    x, w_q, scale = _int8_case(cuda_device, dtype, m, k, n)
    before = ik.launches
    y = ik.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    plan = ik.int8_matmul.last_launch
    assert ik.launches == before + 1
    assert plan["path"] == ik.int8_plan(m, k, n, dtype)["path"]
    assert plan["grid_splits"] == plan["splits"]
    want = ik.int8_matmul_reference(x, w_q, scale)
    err = (y.float() - want.float()).abs().max().item()
    assert err / max(1.0, want.float().abs().max().item()) <= tol
    again = ik.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert torch.equal(again, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,f,k", [(64, 29, 29, 128, 512, 1),
                                         (64, 15, 15, 256, 256, 3)])
def test_bwd_filter_paths_on_card_repeat_bit_identical(cuda_device, dtype,
                                                       n, h, w, c, f, k):
    """K8's tensor-core path (bfloat16) and CUDA-core path (float32) at a
    ResNet-50 1x1 and 3x3 shape at batch 64: within 1e-4 of max(1, max
    |plain|) (both sum float32, in another order), split as planned, and a
    repeat bit-identical (fixed-order second pass, no atomics)."""
    x, _, dy = _conv_inputs(cuda_device, dtype, n, h, w, c, f, k)
    dw = ck.conv2d_same_bwd_filter(x, dy, k)
    torch.cuda.synchronize()
    plan = ck.conv2d_same_bwd_filter.last_launch
    assert plan["path"] == ("tc_bf16" if dtype == torch.bfloat16
                            else "simt_f32")
    assert plan["grid_splits"] == plan["splits"]
    assert plan["grid_positions"] == plan["positions_per_split"]
    assert _rel_err(dw, ck.conv2d_same_bwd_filter_reference(x, dy, k)) \
        <= 1e-4
    again = ck.conv2d_same_bwd_filter(x, dy, k)
    torch.cuda.synchronize()
    assert torch.equal(again, dw)

