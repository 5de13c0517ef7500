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
    flipped rounding of h feeding through the recurrence). The planner's
    layout runs first (clusters at H=40 and 256, one launch at any batch;
    the grid at H=1280, one launch up to 128 rows). The last two shapes
    need more blocks than one co-resident unit-tile grid holds, so with
    that layout forced the wrapper runs them as several launches of row
    chunks."""
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
    h_r, c_r = lk.lstm_seq_fwd_reference(*args)
    plans = [None]
    if batch > 64:
        plans.append({"layout": "unit_tiles", "code": 0})
    for plan in plans:
        before = lk.launches
        h_k, c_k = lk.lstm_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        launch = lk.lstm_seq_fwd.last_launch
        assert lk.launches == before + launch["launches"]
        if plan is None:
            assert launch["layout"] == ("grid" if hidden == 1280
                                        else "cluster")
            assert launch["launches"] == 1
        else:
            # 40 unit tiles x 16 row tiles of 8 > 3 blocks per SM x 132
            # SMs; 600 rows of 8 unit tiles likewise
            assert launch["launches"] >= 2
        torch.testing.assert_close(h_k.float(), h_r.float(), rtol=0,
                                   atol=tol)
        torch.testing.assert_close(c_k.float(), c_r.float(), rtol=0,
                                   atol=tol)


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
    ``bwd_plan``'s for this card: clusters at H=40 and 256 (W's row slice
    resident, one launch), W tiles at H=1280 (resident in bfloat16,
    streamed from L2 in float32), where B=128 runs as two launches of 64
    rows. A repeat is bit-identical (partial sums in a fixed order, no
    atomics)."""
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
    plan = lk.bwd_plan(batch, hidden, dtype, *lk.device_limits(cuda_device))
    assert launch["layout"] == plan["layout"] == (
        "w_tiles" if hidden == 1280 else "cluster")
    if plan["layout"] == "w_tiles":
        assert plan["resident"] == (dtype == torch.bfloat16)
        assert launch["w_placement"] == (4 if plan["resident"] else 3)
        # (D) on the tensor cores in bfloat16 at more than 8 rows a launch
        assert launch["dh_path"] == ("tc_bf16" if dtype == torch.bfloat16
                                     and batch > 8 else "simt_f32")
    else:
        assert launch["w_placement"] == 5
        assert launch["rows_per_block"] == plan["rows_per_block"]
        assert launch["blocks"] == (plan["cluster_size"]
                                    * plan["clusters"])
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
    """The GRU forward kernel against its plain version on the card, in
    the planner's layout and in unit tiles; the tolerance covers the
    different summation order of both GEMVs (and, in bfloat16, one flipped
    rounding of r*h or h feeding through the recurrence). Unit tiles run
    B=600 as several launches of row chunks; a cluster launch is one
    launch at any batch."""
    rng = np.random.RandomState(hidden + batch)
    args = _gru_inputs(rng, cuda_device, dtype, 20, batch, hidden)
    h_r = gk.gru_seq_fwd_reference(*args)
    for plan in (None, {"layout": "unit_tiles", "code": 0}):
        before = gk.launches
        h_k = gk.gru_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        launch = gk.gru_seq_fwd.last_launch
        assert gk.launches == before + launch["launches"]
        if batch <= 64 or launch["layout"] == "cluster":
            assert launch["launches"] == 1, launch
        if batch == 600 and plan is not None:
            assert launch["launches"] >= 2, launch
        assert h_k.dtype == dtype
        torch.testing.assert_close(h_k.float(), h_r.float(), rtol=0,
                                   atol=tol)


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
    feeding through the dh carry). The layout is ``gru_bwd_plan``'s for
    this card: clusters at H=256 and 512 (one launch, whatever the batch),
    unit tiles at H=37 and 1024 (B=600 would run as row chunks there). A
    repeat is bit-identical."""
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
    launch = dict(gk.gru_seq_bwd.last_launch)
    assert gk.bwd_launches == before + launch["launches"]
    _, smem, clusters = gk.device_limits(cuda_device)
    plan = gk.gru_bwd_plan(batch, hidden, dtype, smem, clusters)
    assert launch["layout"] == plan["layout"] == (
        "cluster" if hidden in (256, 512) else "unit_tiles")
    if batch <= 64 or plan["layout"] == "cluster":
        assert launch["launches"] == 1, launch
    want = gk.gru_seq_bwd_reference(*args)
    for name, g, w in zip(("dproj", "dh0"), got, want):
        assert g.dtype == dtype
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * scale,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    again = gk.gru_seq_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


DECODE_SHAPE = (6, 48, 256)  # one decode window of the served tagger


def _decode_window_inputs(rng, device, dtype, kind):
    """One decode window: random non-zero carries, 8 rows of length 0 (an
    idle slot), 8 of length 1 and the rest in [2, T]."""
    steps, batch, hidden = DECODE_SHAPE
    lens = rng.randint(2, steps + 1, batch)
    lens[:8], lens[8:16] = 0, 1

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    gates = 3 if kind == "gru" else 4
    head = (dev(rng.randn(steps, batch, gates * hidden) * 0.5),
            dev(np.arange(steps)[:, None] < lens[None, :], torch.float32))
    if kind == "gru":
        return head + (dev(rng.randn(hidden, 2 * hidden) / np.sqrt(hidden)),
                       dev(rng.randn(hidden, hidden) / np.sqrt(hidden)),
                       dev(rng.randn(batch, hidden) * 0.5))
    return head + (dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
                   dev(rng.randn(3, hidden) * 0.3, torch.float32),
                   dev(rng.randn(batch, hidden) * 0.5),
                   dev(rng.randn(batch, hidden) * 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_decode_window_kernels_carry_state_on_card(cuda_device, kind, dtype,
                                                   tol):
    """K5 and K1 at one decode window of the continuous scheduler (T 6,
    48 slots, H 256) with carried h0 (and c0): against their plain
    versions, a repeat bit-identical, and the rows of length 0 return
    their carry exactly (an idle slot's state passes through)."""
    mod, fn = (gk, "gru_seq_fwd") if kind == "gru" else (lk, "lstm_seq_fwd")
    kernel, reference = getattr(mod, fn), getattr(mod, fn + "_reference")
    args = _decode_window_inputs(np.random.RandomState(6), cuda_device,
                                 dtype, kind)

    def outputs():
        got = kernel(*args)
        return [got] if kind == "gru" else list(got)

    got = outputs()
    want = reference(*args)
    want = [want] if kind == "gru" else list(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
    assert all(torch.equal(a, b) for a, b in zip(outputs(), got))
    carries = args[-1:] if kind == "gru" else args[-2:]
    for seq, carry in zip(got, carries):
        assert torch.equal(seq[-1][:8], carry[:8])
        assert torch.equal(seq[:, :8], carry[:8].expand(6, 8, -1))


def _lstm_bwd_inputs(rng, device, dtype, steps, batch, hidden):
    """Numpy-seeded LSTM backward inputs; lengths include T, 0 and 1."""
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    seq = (steps, batch, hidden)
    return (dev(rng.randn(steps, batch, 4 * hidden) * 0.5),
            dev((np.arange(steps)[:, None] < lens[None, :]), torch.float32),
            dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(3, hidden) * 0.3, torch.float32),
            dev(np.tanh(rng.randn(*seq))), dev(rng.randn(*seq) * 0.5),
            dev(rng.randn(*seq) * 0.5), dev(rng.randn(*seq) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))


def _forced_plan(kind, layout, batch, hidden, dtype, rows, device):
    """The plan of ``layout`` for this shape on this card, its rows per
    block set to ``rows`` where given, or None where the layout does not
    take the shape."""
    mod = gk if kind == "gru" else lk
    sms, smem, clusters = mod.device_limits(device)
    if layout == "unit_tiles":
        return {"layout": "unit_tiles", "code": 0}
    if kind == "gru":
        plan = gk.gru_bwd_plan(batch, hidden, dtype, smem, clusters)
    elif layout == "cluster":
        plan = lk.cluster_plan(batch, hidden, dtype, smem, clusters)
    else:
        plan = lk.bwd_plan(batch, hidden, dtype, sms, smem, clusters,
                           min_hidden=0)
    if plan is None or plan["layout"] != layout:
        return None
    if rows is not None:
        esz = 4 if dtype == torch.float32 else 2
        plan = dict(plan, rows_per_block=rows, clusters=-(-batch // rows),
                    smem_bytes=mod._cl_smem(hidden, rows, esz))
        assert plan["smem_bytes"] <= smem
    return plan


# The recompute passes' float32 products against float64, as a share of
# each element's scale (|bias| + sum of |terms|): full float32 stays
# within it (a sequential float32 sum over K = 256 terms: about 3e-7);
# a TF32 product (10 mantissa bits, about 1e-4) does not.
RECOMPUTE_TOL = 1e-6


def _recompute_error(got, bias, a, b, act=None):
    """max |got - f(bias + a . b)| / (f' x (|bias| + |a| . |b|)) over all
    elements, the product in float64; with an activation ``act``
    ("sigmoid" or "tanh") its own rounding (up to 2^-21) is set aside
    first."""
    a = a.double().reshape(-1, a.shape[-1])
    b = b.double()
    z = bias.double().reshape(a.shape[0], -1) + a @ b
    scale = bias.double().abs().reshape(z.shape) + a.abs() @ b.abs()
    got = got.double().reshape(z.shape)
    if act is None:
        return float(((got - z).abs() / scale).max())
    want = torch.sigmoid(z) if act == "sigmoid" else torch.tanh(z)
    slope = want * (1 - want) if act == "sigmoid" else 1 - want * want
    err = ((got - want).abs() - 2.0 ** -21).clamp(min=0)
    return float((err / (slope * scale)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layout,batch,hidden", [
    ("lstm", "cluster", 64, 256), ("lstm", "w_tiles", 64, 512),
    ("gru", "cluster", 64, 256)])
def test_recompute_pass_is_full_float32_on_card(cuda_device, kind, layout,
                                                batch, hidden):
    """The float32 recompute pass of the cluster and W-tile layouts keeps
    full float32 products, as the forward kernels and the reference do:
    z = gates + hprev . W (LSTM), and u, r = sigmoid(proj_{u,r} + hprev .
    W_rz) and c = tanh(proj_c + rh . W_c) (GRU, with the kernel's own rh),
    as the call leaves them in its workspace, against float64 within
    RECOMPUTE_TOL of each element's scale."""
    rng = np.random.RandomState(hidden + batch)
    steps = 50
    if kind == "lstm":
        args = _lstm_bwd_inputs(rng, cuda_device, torch.float32, steps, batch,
                                hidden)
        plan = _forced_plan(kind, layout, batch, hidden, torch.float32, None,
                            cuda_device)
        _, z = lk._launch_bwd(args, plan)
        torch.cuda.synchronize()
        assert lk.lstm_seq_bwd.last_launch["layout"] == layout
        err = _recompute_error(z, args[0], args[4], args[2])
        assert err <= RECOMPUTE_TOL, err
        return
    proj, mask, w_rz, w_c, _ = _gru_inputs(rng, cuda_device, torch.float32,
                                           steps, batch, hidden)
    hprev = torch.tanh(torch.tensor(rng.randn(steps, batch, hidden),
                                    dtype=torch.float32, device=cuda_device))
    dh = torch.zeros_like(hprev)
    plan = _forced_plan(kind, layout, batch, hidden, torch.float32, None,
                        cuda_device)
    _, (zbuf, rh) = gk._launch_bwd(
        (proj, mask, w_rz, w_c, hprev, dh, dh[0]), plan)
    torch.cuda.synchronize()
    assert gk.gru_seq_bwd.last_launch["layout"] == layout
    h2 = 2 * hidden
    for name, got, bias, a, b, act in (
            ("u, r", zbuf[..., :h2], proj[..., :h2], hprev, w_rz, "sigmoid"),
            ("c", zbuf[..., h2:], proj[..., h2:], rh, w_c, "tanh")):
        err = _recompute_error(got, bias, a, b, act)
        assert err <= RECOMPUTE_TOL, (name, err)


# (B, H, rows per block of a cluster; None: the planner's): H = 96 (3 unit
# tiles) and 200 (7, the last of 8 units), B not a multiple of the rows, the
# flagship's and the tagger's widths at their trained batch and at B=1, and
# for the GRU the NMT encoder's width (clusters of 16) and a batch whose
# unit tiles run as row chunks
BWD_LAYOUT_SHAPES = [(6, 96, 4), (3, 200, 2), (9, 256, 5), (13, 256, 8),
                     (64, 256, None), (1, 256, None)]
GRU_LAYOUT_SHAPES = BWD_LAYOUT_SHAPES + [(64, 512, None), (600, 256, None)]


def _check_bwd_outputs(got, want, tol, dtype, dpeep=False):
    names = ("dgates", "dh0", "dc0") if dpeep else ("dproj", "dh0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == dtype
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * scale,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    if dpeep:
        scale = float(want[3].abs().max())
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=tol * scale,
                                   msg=lambda m: "dpeep: %s" % m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch,hidden,rows", BWD_LAYOUT_SHAPES)
@pytest.mark.parametrize("layout", ["unit_tiles", "cluster", "w_tiles"])
def test_bwd_layouts_forced_on_card(cuda_device, layout, batch, hidden,
                                    rows, dtype, tol):
    """Each layout of the LSTM backward, forced by ``plan=``, against the
    plain version on the card (TOL_BWD of chip_smoke.py), with ragged
    masks (lengths T, 0 and 1), batches that are no multiple of the rows
    per block, and widths of 3 and 7 unit tiles; one counted launch of
    the recurrence (the cluster's recompute pass is part of it), and a
    repeat that is bit-identical."""
    rng = np.random.RandomState(31 * hidden + batch)
    args = _lstm_bwd_inputs(rng, cuda_device, dtype, 20, batch, hidden)
    plan = _forced_plan("lstm", layout, batch, hidden, dtype, rows,
                        cuda_device)
    assert plan is not None
    before = lk.bwd_launches
    got = lk.lstm_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    launch = dict(lk.lstm_seq_bwd.last_launch)
    assert launch["layout"] == layout and launch["launches"] == 1
    assert lk.bwd_launches == before + 1
    if layout == "cluster":
        assert launch["rows_per_block"] == plan["rows_per_block"]
        assert rows is None or plan["rows_per_block"] == rows
    _check_bwd_outputs(got, lk.lstm_seq_bwd_reference(*args), tol, dtype,
                       dpeep=True)
    again = lk.lstm_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("batch,hidden,rows", GRU_LAYOUT_SHAPES)
@pytest.mark.parametrize("layout", ["unit_tiles", "cluster"])
def test_gru_bwd_layouts_forced_on_card(cuda_device, layout, batch, hidden,
                                        rows, dtype, tol):
    """Each layout of the GRU backward, forced by ``plan=``, against the
    plain version on the card, as test_bwd_layouts_forced_on_card; unit
    tiles at B=600 run as several launches of row chunks, a cluster launch
    is one launch at any batch."""
    rng = np.random.RandomState(37 * hidden + batch)
    args = _gru_inputs(rng, cuda_device, dtype, 20, batch, hidden)
    h_seq = gk.gru_seq_fwd_reference(*args)
    args = (args[0], args[1], args[2], args[3],
            torch.cat([args[4][None], h_seq[:-1]]),
            torch.tensor(rng.randn(20, batch, hidden) * 0.5, dtype=dtype,
                         device=cuda_device),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=dtype,
                         device=cuda_device))
    plan = _forced_plan("gru", layout, batch, hidden, dtype, rows,
                        cuda_device)
    assert plan is not None
    before = gk.bwd_launches
    got = gk.gru_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    launch = dict(gk.gru_seq_bwd.last_launch)
    assert launch["layout"] == layout
    assert gk.bwd_launches == before + launch["launches"]
    if layout == "cluster" or batch <= 64:
        assert launch["launches"] == 1, launch
    else:
        assert launch["launches"] >= 2, launch
    if layout == "cluster":
        assert launch["w_placement"] == 5
        assert rows is None or launch["rows_per_block"] == rows
    _check_bwd_outputs(got, gk.gru_seq_bwd_reference(*args), tol, dtype)
    again = gk.gru_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("layout", ["unit_tiles", "cluster", "w_tiles"])
def test_bwd_layouts_at_the_bilstm_shape_on_card(cuda_device, layout, dtype,
                                                 tol):
    """Each layout of the LSTM backward at the BiLSTM-CRF tagger's
    (T, B, H) = (60, 32, 128) (the planner's choice there, clusters of 4
    blocks, never ran before the tagger), against the plain version with
    ragged masks, one counted launch and a bit-identical repeat."""
    rng = np.random.RandomState(60 * 128 + 32)
    args = _lstm_bwd_inputs(rng, cuda_device, dtype, 60, 32, 128)
    plan = _forced_plan("lstm", layout, 32, 128, dtype, None, cuda_device)
    assert plan is not None
    if layout == "cluster":
        sms, smem, clusters = lk.device_limits(cuda_device)
        assert lk.bwd_plan(32, 128, dtype, sms, smem, clusters) == plan
        assert plan["cluster_size"] == 4
    before = lk.bwd_launches
    got = lk.lstm_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    assert lk.lstm_seq_bwd.last_launch["layout"] == layout
    assert lk.bwd_launches == before + 1
    _check_bwd_outputs(got, lk.lstm_seq_bwd_reference(*args), tol, dtype,
                       dpeep=True)
    again = lk.lstm_seq_bwd(*args, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_refused_cluster_launch_raises_on_card(cuda_device):
    """A cluster plan the kernel does not take raises; nothing falls back
    to another layout or to the plain version: rows per block the kernel
    is not compiled for (3), a width that is no multiple of 8, an LSTM
    float32 block whose row slice exceeds the card's shared memory (H=480:
    240 KB), and a GRU cluster of 17 blocks (H=544)."""
    rng = np.random.RandomState(3)
    for batch, hidden, rows in ((6, 96, 3), (6, 100, 1), (2, 480, 1)):
        args = _lstm_bwd_inputs(rng, cuda_device, torch.float32, 4, batch,
                                hidden)
        plan = {"layout": "cluster", "code": 2, "rows_per_block": rows}
        before = lk.bwd_launches
        with pytest.raises(RuntimeError, match="lstm_seq_bwd kernel launch "
                           "failed"):
            lk.lstm_seq_bwd(*args, plan=plan)
        assert lk.bwd_launches == before
    for batch, hidden, rows in ((6, 96, 3), (6, 100, 1), (2, 544, 1)):
        plan = {"layout": "cluster", "code": 2, "rows_per_block": rows}
        before = gk.bwd_launches
        gargs = _gru_inputs(rng, cuda_device, torch.float32, 4, batch,
                            hidden)
        gargs = gargs[:4] + (gargs[4][None].expand(4, -1, -1).contiguous(),
                             torch.zeros(4, batch, hidden, device=cuda_device),
                             gargs[4])
        with pytest.raises(RuntimeError, match="gru_seq_bwd kernel launch "
                           "failed"):
            gk.gru_seq_bwd(*gargs, plan=plan)
        assert gk.bwd_launches == before


# (T, B, H) of the forward layouts: widths of 3 and 7 unit tiles (H=96, 200)
# and batches no multiple of the rows per block, the served and trained
# flagship, H=384 (12 unit tiles: W in shared memory), H=512 (clusters of
# 16 in bfloat16; the grid's 4 units a block), the wide model, B=130 at
# H=768 (the grid in two launches of 65 rows, two passes each), and the
# BiLSTM-CRF tagger's (60, 32, 128) (clusters of 4 blocks)
FWD_LAYOUT_SHAPES = [(20, 6, 96), (20, 3, 200), (64, 32, 256),
                     (20, 64, 256), (20, 64, 384), (20, 64, 512),
                     (30, 64, 1280), (10, 130, 768), (60, 32, 128)]


def _lstm_fwd_inputs(rng, device, dtype, steps, batch, hidden):
    """Numpy-seeded LSTM forward inputs: lengths include T, 0 and 1,
    nonzero peepholes, h0 and c0."""
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    return (dev(rng.randn(steps, batch, 4 * hidden) * 0.5),
            dev((np.arange(steps)[:, None] < lens[None, :]), torch.float32),
            dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(3, hidden) * 0.3, torch.float32),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))


def _fwd_plans(kind, batch, hidden, dtype, device):
    """{layout: plan} of every forward layout that takes the shape on this
    card."""
    plans = {"unit_tiles": {"layout": "unit_tiles", "code": 0}}
    if kind == "lstm":
        sms, smem, clusters = lk.fwd_device_limits(device)
        plans["cluster"] = lk.fwd_cluster_plan(batch, hidden, dtype, smem,
                                               clusters)
        plans["grid"] = lk.grid_plan(batch, hidden, dtype, sms, smem)
    else:
        _, smem, clusters = gk.fwd_device_limits(device)
        plans["cluster"] = gk.fwd_cluster_plan(batch, hidden, dtype, smem,
                                               clusters)
    return {k: v for k, v in plans.items() if v is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("steps,batch,hidden", FWD_LAYOUT_SHAPES)
def test_fwd_layouts_forced_on_card(cuda_device, steps, batch, hidden, dtype,
                                    tol):
    """Every layout of the LSTM forward that takes the shape, forced by
    ``plan=``, against the plain version on the card (TOL_F32 / TOL_BF16
    of chip_smoke.py), with ragged masks (lengths T, 0 and 1) and nonzero
    h0 and c0; counted launches, and a repeat that is bit-identical."""
    rng = np.random.RandomState(41 * hidden + batch)
    args = _lstm_fwd_inputs(rng, cuda_device, dtype, steps, batch, hidden)
    want = lk.lstm_seq_fwd_reference(*args)
    plans = _fwd_plans("lstm", batch, hidden, dtype, cuda_device)
    assert "grid" in plans  # at most 10 units a block at every width here
    for layout, plan in plans.items():
        before = lk.launches
        got = lk.lstm_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        launch = dict(lk.lstm_seq_fwd.last_launch)
        assert launch["layout"] == layout
        assert lk.launches == before + launch["launches"]
        if layout == "cluster":
            assert launch["launches"] == 1
            assert launch["rows_per_block"] == plan["rows_per_block"]
        if layout == "grid":
            assert launch["launches"] == -(-batch // plan["rows_per_launch"])
            assert launch["blocks"] == plan["blocks"]
        for name, g, w in zip(("h_seq", "c_seq"), got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(
                g.float(), w.float(), rtol=0, atol=tol,
                msg=lambda m, n=name, lay=layout: "%s %s: %s" % (lay, n, m))
        again = lk.lstm_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got)), layout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("steps,batch,hidden", [
    (20, 6, 96), (20, 3, 200), (128, 32, 256), (20, 64, 256),
    (20, 64, 512), (20, 600, 256)])
def test_gru_fwd_layouts_forced_on_card(cuda_device, steps, batch, hidden,
                                        dtype, tol):
    """Both layouts of the GRU forward, forced by ``plan=``, against the
    plain version on the card, as test_fwd_layouts_forced_on_card; the
    clusters of 16 at H=512 run in two waves (13 or 8 clusters of the 7 a
    card holds), which is slower but right."""
    rng = np.random.RandomState(43 * hidden + batch)
    args = _gru_inputs(rng, cuda_device, dtype, steps, batch, hidden)
    want = gk.gru_seq_fwd_reference(*args)
    plans = _fwd_plans("gru", batch, hidden, dtype, cuda_device)
    assert "cluster" in plans
    for layout, plan in plans.items():
        before = gk.launches
        got = gk.gru_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        launch = dict(gk.gru_seq_fwd.last_launch)
        assert launch["layout"] == layout
        assert gk.launches == before + launch["launches"]
        if layout == "cluster":
            assert launch["launches"] == 1 and launch["w_placement"] == 5
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol, msg=lambda m, lay=layout:
                                   "%s: %s" % (lay, m))
        again = gk.gru_seq_fwd(*args, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(again, got), layout


@pytest.mark.cuda
def test_forced_fwd_plan_the_card_cannot_hold_raises(cuda_device):
    """A forward plan the card or the kernel does not take raises; nothing
    falls back to another layout or to the plain version: cluster rows the
    kernel is not compiled for (6), a width that is no multiple of 8, a
    float32 LSTM cluster block whose W slice exceeds the shared memory
    (H=512: 256 KB), a GRU cluster of 17 blocks (H=544), a grid of an odd
    unit count or of 12 units a block, and a float32 grid block whose
    slice exceeds the shared memory (H=1536, 12 units; 10 units would
    need 154 blocks, more than the card's SMs)."""
    rng = np.random.RandomState(5)
    cases = [((6, 96), {"layout": "cluster", "code": 2,
                        "rows_per_block": 6}),
             ((6, 100), {"layout": "cluster", "code": 2,
                         "rows_per_block": 1}),
             ((2, 512), {"layout": "cluster", "code": 2,
                         "rows_per_block": 1}),
             ((4, 1280), {"layout": "grid", "code": 1, "units": 9,
                          "rows_per_launch": 4, "passes": 1}),
             ((4, 1280), {"layout": "grid", "code": 1, "units": 12,
                          "rows_per_launch": 4, "passes": 1}),
             ((4, 1536), {"layout": "grid", "code": 1, "units": 10,
                          "rows_per_launch": 4, "passes": 1})]
    for (batch, hidden), plan in cases:
        args = _lstm_fwd_inputs(rng, cuda_device, torch.float32, 3, batch,
                                hidden)
        before = lk.launches
        with pytest.raises(RuntimeError, match="lstm_seq_fwd kernel launch "
                           "failed"):
            lk.lstm_seq_fwd(*args, plan=plan)
        assert lk.launches == before, (batch, hidden, plan)
    for batch, hidden, rows in ((6, 96, 6), (6, 100, 1), (2, 544, 1)):
        gargs = _gru_inputs(rng, cuda_device, torch.float32, 3, batch,
                            hidden)
        before = gk.launches
        with pytest.raises(RuntimeError, match="gru_seq_fwd kernel launch "
                           "failed"):
            gk.gru_seq_fwd(*gargs, plan={"layout": "cluster", "code": 2,
                                         "rows_per_block": rows})
        assert gk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layout,batch,hidden", [
    ("lstm", "cluster", 32, 256), ("lstm", "grid", 64, 1280),
    ("lstm", "grid", 64, 512), ("lstm", "cluster", 64, 384),
    ("gru", "cluster", 64, 256), ("gru", "cluster", 8, 512)])
def test_fwd_product_is_full_float32_on_card(cuda_device, kind, layout,
                                            batch, hidden):
    """The float32 forward layouts form their products in full float32, as
    the reference does: one step whose cell returns tanh of the product
    (LSTM: input gate saturated open, forget gate shut, c0 = 0, so c_1 =
    tanh(h0 . W_g); GRU: update gate shut, reset gate open, so h_1 =
    tanh(h0 . W_c)), inverted in float64 and held against the float64
    product within RECOMPUTE_TOL of each element's scale. A TF32-class
    product (10 mantissa bits) misses by about 1e-4."""
    rng = np.random.RandomState(hidden + batch)
    dev = cuda_device
    h0 = torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=torch.float32,
                      device=dev)
    mask = torch.ones((1, batch), device=dev)
    plans = _fwd_plans(kind, batch, hidden, torch.float32, dev)
    plan = plans[layout]
    if kind == "lstm":
        w = torch.tensor(rng.randn(hidden, 4 * hidden) * 0.1 / np.sqrt(hidden),
                         dtype=torch.float32, device=dev)
        gates = torch.zeros((1, batch, 4 * hidden), device=dev)
        gates[..., :hidden] = 30.0           # i = 1
        gates[..., hidden:2 * hidden] = -30.0  # f = 0 (c0 = 0 anyway)
        peep = torch.zeros((3, hidden), device=dev)
        _, c_seq = lk.lstm_seq_fwd(gates, mask, w, peep, h0,
                                   torch.zeros_like(h0), plan=plan)
        torch.cuda.synchronize()
        assert lk.lstm_seq_fwd.last_launch["layout"] == layout
        got, b = c_seq[0], w[:, 2 * hidden:3 * hidden]
    else:
        w_rz = torch.tensor(rng.randn(hidden, 2 * hidden) / np.sqrt(hidden),
                            dtype=torch.float32, device=dev)
        w_c = torch.tensor(rng.randn(hidden, hidden) * 0.1 / np.sqrt(hidden),
                           dtype=torch.float32, device=dev)
        proj = torch.zeros((1, batch, 3 * hidden), device=dev)
        proj[..., :hidden] = -30.0            # u = 0: h_1 = c
        proj[..., hidden:2 * hidden] = 30.0   # r = 1: rh = h0
        got = gk.gru_seq_fwd(proj, mask, w_rz, w_c, h0, plan=plan)[0]
        torch.cuda.synchronize()
        assert gk.gru_seq_fwd.last_launch["layout"] == layout
        b = w_c
    z = torch.atanh(got.double())
    want = h0.double() @ b.double()
    scale = h0.double().abs() @ b.double().abs()
    err = float(((z - want).abs() / scale).max())
    assert err <= RECOMPUTE_TOL, err


# (N, H, W, C, F, k): ResNet-50 stage shapes at a small batch, N=1, the
# narrowest channels at odd sizes, a stage-4 3x3 at batch 64; and for K7's
# tiles: C=F=8 at 17x23 (one 16-byte bfloat16 copy is a whole tap), F=192
# (not a multiple of 128) in 128-filter tiles, and ResNet-50's widest 1x1
# at batch 64; then GoogleNet's tails: C = 112, 144 and 528 leave a partial
# last K chunk (k*k*C = 1008, 1296, 528), F = 16, 32, 48 fill part of a
# 64-filter tile and F = 208 part of a 128-filter one, and K8's rows
# (1008, 1296) are no multiple of its 128-row tile
CONV_SHAPES = [(2, 57, 57, 64, 64, 3), (2, 57, 57, 64, 256, 1),
               (2, 29, 29, 512, 128, 1), (1, 8, 8, 2048, 512, 1),
               (1, 15, 15, 256, 256, 3), (3, 7, 5, 8, 8, 3),
               (2, 9, 11, 8, 24, 1), (64, 15, 15, 256, 256, 3),
               (1, 57, 57, 64, 64, 3), (64, 17, 23, 8, 8, 3),
               (64, 29, 29, 128, 192, 1), (64, 8, 8, 512, 2048, 1),
               (2, 14, 14, 112, 224, 3), (2, 14, 14, 144, 288, 3),
               (2, 14, 14, 96, 208, 3), (2, 14, 14, 528, 32, 1),
               (2, 7, 7, 832, 48, 1), (2, 28, 28, 192, 16, 1)]


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
@pytest.mark.parametrize("m,k,n", [(512, 16, 64), (512, 64, 32),
                                   (512, 32, 1), (32, 19, 16), (32, 32, 64),
                                   (32, 16, 64), (8, 19, 16), (1, 19, 16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_int8_matmul_at_the_recommender_shapes_on_card(cuda_device, dtype,
                                                       tol, m, k, n, offset):
    """K9 at the int8 CTR's products (M = 512 at K = 16, 32, 64; N = 1: a
    w_q row one byte wide) and the int8 movielens bundle's (K = 19: x rows
    that are not a multiple of 16 bytes), with x at a 16-byte aligned base
    and one element past it: against the plain version, one launch, and a
    bit-identical repeat."""
    x, w_q, scale = _int8_case(cuda_device, dtype, m, k, n)
    if offset:
        x = torch.cat([torch.zeros(1, dtype=dtype, device=cuda_device),
                       x.reshape(-1)])[offset:].reshape(m, k)
    before = ik.launches
    y = ik.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert ik.launches == before + 1
    assert ik.int8_matmul.last_launch["path"] == ik.int8_plan(
        m, k, n, dtype)["path"]
    assert y.dtype == dtype and y.shape == (m, n)
    want = ik.int8_matmul_reference(x, w_q, scale)
    err = (y.float() - want.float()).abs().max().item()
    assert err / max(1.0, want.float().abs().max().item()) <= tol
    assert torch.equal(ik.int8_matmul(x, w_q, scale), y)


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



@pytest.mark.cuda
def test_dropout_masks_on_a_card_generator(cuda_device):
    """``ops.dropout`` on the card: masks from a CUDA generator repeat for
    one seed and differ across seeds, their kept share at 128 x 4096 is
    within 4 sigma of 1 - rate, the kept values are scaled by 1 / keep,
    and a CPU generator for a card tensor raises."""
    from paddle_tpu_torch.graph import Context
    from paddle_tpu_torch.ops import dropout as dropout_ops
    from paddle_tpu_torch.utils.error import EnforceError

    x = torch.ones(128, 4096, device=cuda_device)
    rate = 0.4

    def run(seed):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        return dropout_ops.dropout(x, rate, gen)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    share = kept.float().mean().item()
    assert abs(share - 0.6) <= 4 * (0.6 * 0.4 / x.numel()) ** 0.5
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.6))
    ctx = Context(mode="train", generator=torch.Generator())
    with pytest.raises(EnforceError, match="generator is on cpu"):
        ctx.rng_for(x)


def _loop_trainer(device, build):
    """A trainer of the network ``build()`` returns (cost, parameters) on
    ``device``, from a copy of the parameters, with Momentum(0.05, 0.9)."""
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.parameters import Parameters

    cost, init = build()
    params = Parameters({k: v.clone() for k, v in init.as_dict().items()},
                        {n: init.spec(n) for n in init.names()})
    return trainer.SGD(cost, params, optimizer.Momentum(
        learning_rate=0.05, momentum=0.9), device=device)


def _run_loop(tr, batches, **options):
    from paddle_tpu_torch.event import EndIteration

    costs = []
    tr.train(lambda: iter(batches), event_handler=lambda e: costs.append(
        e.cost) if isinstance(e, EndIteration) else None, **options)
    return costs


def _small_lstm():
    from paddle_tpu_torch import data_type, layer
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.models.text import text_classification_lstm
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    reset_name_counters()
    out = text_classification_lstm(dict_size=50, emb_size=16, hidden=32,
                                   num_classes=2, num_layers=2)
    label = layer.data(name="label", type=data_type.integer_value(2))
    cost = layer.classification_cost(input=out, label=label)
    return cost, Parameters.create(Topology(cost), seed=3, device="cpu")


@pytest.mark.cuda
def test_fused_loop_captures_the_lstm_steps_as_one_graph(cuda_device):
    """steps_per_call=4 on the card: 8 batches of one shape run as two
    replays of one captured graph of 4 steps, in which the wrappers
    counted 2 LSTM forward and 2 backward launches a step; costs and
    parameters equal the eager per-step run's within 1e-6."""
    rng = np.random.RandomState(0)
    batches = [[(rng.randint(0, 50, 12).tolist(), int(rng.randint(0, 2)))
                for _ in range(8)] for _ in range(8)]
    eager = _loop_trainer(cuda_device, _small_lstm)
    fused = _loop_trainer(cuda_device, _small_lstm)
    want = _run_loop(eager, batches)
    got = _run_loop(fused, batches, feed_pipeline=2, steps_per_call=4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for n in eager.parameters.names():
        np.testing.assert_allclose(fused.parameters.get(n),
                                   eager.parameters.get(n), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    assert len(fused.graphs) == 1
    info = fused.graphs[0]
    assert info["steps"] == 4 and info["replays"] == 2
    assert info["captured"] == {"lstm_seq_fwd": 8, "lstm_seq_bwd": 8}
    assert fused.graph_launches()["replayed"] == {"lstm_seq_fwd": 16,
                                                  "lstm_seq_bwd": 16}


@pytest.mark.cuda
def test_two_replays_of_a_captured_step_use_steps_one_and_two(cuda_device):
    """The optimizer's step count and schedule live on the card: a graph
    captured at step 1 and replayed twice updates with the learning rates
    of steps 1 and 2 (poly schedule), and the count reads 2."""
    from paddle_tpu_torch import optimizer

    opt = optimizer.Momentum(learning_rate=0.1, learning_rate_schedule="poly",
                             learning_rate_decay_a=0.5,
                             learning_rate_decay_b=2.0)
    p = {"w": torch.zeros(4, device=cuda_device)}
    g = {"w": torch.ones(4, device=cuda_device)}
    state = opt.init_state(p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step(p, g, state)
    deltas = []
    for _ in range(2):
        before = p["w"].clone()
        graph.replay()
        deltas.append(float((before - p["w"])[0]))
    assert int(state["step"]) == 2
    want = [0.1 * (1 + 0.5 * s) ** -2.0 for s in (1, 2)]
    np.testing.assert_allclose(deltas, want, rtol=1e-6)


def _dropout_net():
    from paddle_tpu_torch import activation, data_type, layer
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    reset_name_counters()
    x = layer.data(name="x", type=data_type.dense_vector(16))
    y = layer.data(name="y", type=data_type.integer_value(2))
    h = layer.dropout(layer.fc(input=x, size=64, act=activation.Relu()),
                      dropout_rate=0.5)
    out = layer.fc(input=h, size=2, act=activation.Softmax())
    cost = layer.classification_cost(input=out, label=y)
    return cost, Parameters.create(Topology(cost), seed=4, device="cpu")


@pytest.mark.cuda
def test_dropout_under_steps_per_call_draws_the_eager_masks(cuda_device):
    """A dropout network under steps_per_call=4: the graph registers the
    trainer's generator, so each replay draws fresh masks — the costs
    equal the eager run's, step for step, and a replay is not a repeat
    of the one before (the same batch twice in a row gives two costs)."""
    rng = np.random.RandomState(1)
    one = [(rng.randn(16).astype(np.float32), int(rng.randint(0, 2)))
           for _ in range(8)]
    batches = [one] * 8
    eager = _loop_trainer(cuda_device, _dropout_net)
    fused = _loop_trainer(cuda_device, _dropout_net)
    want = _run_loop(eager, batches)
    got = _run_loop(fused, batches, steps_per_call=4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert len(fused.graphs) == 1 and fused.graphs[0]["replays"] == 2
    assert len(set(got)) == len(got)


@pytest.mark.cuda
def test_fused_loop_under_the_bf16_policy(cuda_device):
    """The fused loop under the bfloat16 compute policy (float32 masters):
    the graph runs the same bfloat16 kernels as the eager loop, so costs
    and parameters agree within 1e-6."""
    from paddle_tpu_torch.core import dtype as dtype_mod

    rng = np.random.RandomState(2)
    batches = [[(rng.randint(0, 50, 12).tolist(), int(rng.randint(0, 2)))
                for _ in range(8)] for _ in range(4)]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        eager = _loop_trainer(cuda_device, _small_lstm)
        fused = _loop_trainer(cuda_device, _small_lstm)
        want = _run_loop(eager, batches)
        got = _run_loop(fused, batches, steps_per_call=4)
    finally:
        dtype_mod.set_mixed_precision(None)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for n in eager.parameters.names():
        np.testing.assert_allclose(fused.parameters.get(n),
                                   eager.parameters.get(n), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    assert len(fused.graphs) == 1 and fused.graphs[0]["replays"] == 1


@pytest.mark.cuda
def test_attribution_capture_sees_the_lstm_kernels(cuda_device):
    """observe.attribution.capture over 4 eager steps of the small LSTM
    classifier: the CUDA kernel events include the LSTM forward and
    backward kernels, the busy time is at most the device window, and both
    idle shares lie in [0, 1)."""
    from paddle_tpu_torch.observe import attribution

    rng = np.random.RandomState(2)
    batches = [[(rng.randint(0, 50, 12).tolist(), int(rng.randint(0, 2)))
                for _ in range(8)] for _ in range(4)]
    tr = _loop_trainer(cuda_device, _small_lstm)
    _run_loop(tr, batches[:1])  # the kernels load before the capture
    trace = attribution.capture(lambda: _run_loop(tr, batches),
                                torch.cuda.synchronize)
    assert trace is not None and trace.kernels
    prof = attribution.step_profile(trace, len(batches),
                                    ("lstm_fwd", "lstm_bwd"))
    assert prof["kernels"]["lstm_fwd"]["ms_per_step"] > 0
    assert prof["kernels"]["lstm_bwd"]["ms_per_step"] > 0
    assert 0 < trace.busy_us <= trace.window_us
    assert 0 <= prof["idle_share"] < 1
    assert 0 <= prof["device_window_idle_share"] < 1
    gap = attribution.dispatch_gap(trace, steps=len(batches))
    assert gap["execs_per_step"] == prof["kernels_per_step"]


@pytest.mark.cuda
def test_trap_fpe_under_a_captured_graph(cuda_device):
    """trap_fpe with steps_per_call=4: the finiteness flags are computed
    inside the captured graph and read at the chunk's finalize. A first
    run captures the graph with the flags; then a NaN written into the
    embedding table makes the next replay's cost NaN, and
    FloatingPointError names the cost of its step."""
    from paddle_tpu_torch.utils import flags

    rng = np.random.RandomState(3)
    batches = [[(rng.randint(0, 50, 12).tolist(), int(rng.randint(0, 2)))
                for _ in range(8)] for _ in range(4)]
    tr = _loop_trainer(cuda_device, _small_lstm)
    table = "lstm_emb.w0"  # the embedding table
    flags.set_flag("trap_fpe", True)
    try:
        _run_loop(tr, batches, feed_pipeline=2, steps_per_call=4)
        with torch.no_grad():
            tr._trainable[table][batches[0][0][0][0]] = float("nan")
        with pytest.raises(FloatingPointError,
                           match=r"step 5 \(pass 0, batch 0\): the cost "
                                 "holds a NaN"):
            _run_loop(tr, batches, feed_pipeline=2, steps_per_call=4)
    finally:
        flags.set_flag("trap_fpe", False)
    assert len(tr.graphs) == 1 and tr.graphs[0]["replays"] == 2
