"""The LSTM backward of the port against the JAX package, on the CPU.

- ``lstm_seq_bwd_reference`` (the plain version of csrc/lstm_seq_bwd.cu)
  against the Pallas backward kernels in interpret mode, as
  tests/test_pallas_kernels.py runs them: ``_lstm_bwd_resident`` (K2) at
  H=64 and ``_lstm_bwd_tiled`` (K4) at H=256.
- The gradients of the port's ``rnn.lstm_scan`` (its kernel branch is the
  ``LstmSeq`` autograd Function) against ``jax.grad`` of the JAX
  ``lstm_scan`` on its fused path in interpret mode, with a check that the
  plain backward, not autograd through the plain forward, produced them.

Inputs come from a numpy seed: peepholes, h0, c0, dh_f and dc_f are
nonzero and the lengths include 0, 1 and T. Tolerances, float32: the JAX
kernels and the port's loop sum the same products in another order
(XLA's dot against torch.matmul on the CPU), and the errors compound
through the T reverse steps; 5e-6 absolute and relative is six times the
largest |err| these inputs show (8.3e-7, on gradients of size 1-4), and
far tighter than the 2e-4/2e-5 and 2e-3/2e-4 that test_pallas_kernels.py
allows the kernels against lax.scan.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu_torch.ops import clusters
from paddle_tpu_torch.ops import lstm_kernels as lk
from paddle_tpu_torch.ops import rnn as torch_rnn

B, T = 4, 6
LENGTHS = np.array([T, 0, 3, 1])
TOL = 5e-6


@pytest.fixture
def interpret(monkeypatch):
    if not pk.available():
        pytest.skip("pallas unavailable in this JAX install")
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _bwd_inputs(hidden, seed):
    """Time-major backward inputs; hprev/cprev/c_seq from the forward."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    gates = (rng.randn(T, B, 4 * hidden) * 0.5).astype(np.float32)
    w = (rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)).astype(np.float32)
    peep = (rng.randn(3, hidden) * 0.3).astype(np.float32)
    h0 = (rng.randn(B, hidden) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, hidden) * 0.5).astype(np.float32)
    h_seq, c_seq = lk.lstm_seq_fwd_reference(*(torch.from_numpy(a) for a in (
        gates, mask, w, peep, h0, c0)))
    h_seq, c_seq = h_seq.numpy(), c_seq.numpy()
    return {
        "gates": gates, "mask": mask, "w": w, "peep": peep,
        "hprev": np.concatenate([h0[None], h_seq[:-1]]),
        "cprev": np.concatenate([c0[None], c_seq[:-1]]),
        "c_seq": c_seq,
        "dh_seq": (rng.randn(T, B, hidden) * 0.5).astype(np.float32),
        "dh_f": (rng.randn(B, hidden) * 0.5).astype(np.float32),
        "dc_f": (rng.randn(B, hidden) * 0.5).astype(np.float32),
    }


_ORDER = ("gates", "mask", "w", "peep", "hprev", "cprev", "c_seq", "dh_seq",
          "dh_f", "dc_f")


@pytest.mark.parametrize("hidden,kernel", [(64, "resident_K2"),
                                           (256, "tiled_K4")])
def test_bwd_reference_matches_jax_kernel(hidden, kernel, interpret):
    assert pk.lstm_mode(B, hidden, jnp.float32) == kernel.split("_")[0]
    x = _bwd_inputs(hidden, seed=hidden)
    jax_bwd = (pk._lstm_bwd_resident if kernel == "resident_K2"
               else pk._lstm_bwd_tiled)
    want = jax_bwd(*(jnp.asarray(x[k]) for k in _ORDER))
    got = lk.lstm_seq_bwd_reference(*(torch.from_numpy(x[k])
                                      for k in _ORDER))
    for name, g, w in zip(("dgates", "dh0", "dc0", "dpeep"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_bwd_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x = {k: torch.from_numpy(v) for k, v in _bwd_inputs(16, seed=5).items()}
    before = lk.bwd_launches
    got = lk.lstm_seq_bwd(*(x[k] for k in _ORDER))
    want = lk.lstm_seq_bwd_reference(*(x[k] for k in _ORDER))
    assert lk.bwd_launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # a length-0 row passes dh and dc straight through
    d = x["dh_f"][1] + x["dh_seq"][:, 1].sum(0)
    torch.testing.assert_close(got[1][1], d, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[2][1], x["dc_f"][1])
    assert not got[0][:, 1].any()


@pytest.mark.parametrize("index,bad,match", [
    (0, torch.zeros(B, 64), r"\[T, B, 4H\]"),
    (4, torch.zeros(T, B, 8), "hprev_tm must be"),
    (7, torch.zeros(T, B, 16, dtype=torch.bfloat16), "dh_seq must be"),
    (3, torch.zeros(3, 16, dtype=torch.bfloat16), "peep must be"),
    (9, torch.zeros(B, 16, dtype=torch.float64), "dc_f must be"),
])
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(index, bad, match):
    from paddle_tpu_torch.utils.error import EnforceError

    args = [torch.from_numpy(v) for v in
            (_bwd_inputs(16, seed=6)[k] for k in _ORDER)]
    args[index] = bad
    with pytest.raises(EnforceError, match=match):
        lk.lstm_seq_bwd(*args)


def test_bwd_reference_bf16_tracks_f32():
    """bfloat16 inputs: dz is rounded to bfloat16 for dgates and before
    dz . W^T, tanh(c_t) reads the bfloat16 c_seq; the gradients stay within
    bfloat16 rounding of the float32 run (dpeep, summed in f32 over B and
    T, within a few bfloat16 ulps of its size)."""
    x = _bwd_inputs(64, seed=7)
    f32 = [torch.from_numpy(x[k]) for k in _ORDER]
    bf = [a if i in (1, 3) else a.bfloat16() for i, a in enumerate(f32)]
    want = lk.lstm_seq_bwd_reference(*f32)
    got = lk.lstm_seq_bwd_reference(*bf)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for name, g, w, tol in zip(("dgates", "dh0", "dc0", "dpeep"), got, want,
                               (3e-2, 5e-2, 5e-2, 1e-1)):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=tol,
                                   err_msg=name)


def _scan_inputs(hidden, seed):
    rng = np.random.RandomState(seed)
    return {
        "gates": (rng.randn(B, T, 4 * hidden) * 0.5).astype(np.float32),
        "mask": (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32),
        "w": (rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)).astype(
            np.float32),
        "peep": (rng.randn(3 * hidden) * 0.3).astype(np.float32),
        "h0": (rng.randn(B, hidden) * 0.5).astype(np.float32),
        "c0": (rng.randn(B, hidden) * 0.5).astype(np.float32),
        # cotangents of h_seq [B, T, H], h_f and c_f
        "r_seq": rng.randn(B, T, hidden).astype(np.float32),
        "r_h": rng.randn(B, hidden).astype(np.float32),
        "r_c": rng.randn(B, hidden).astype(np.float32),
    }


_WRT = ("gates", "w", "peep", "h0", "c0")


def _jax_grads(x):
    def loss(gates, w, peep, h0, c0):
        h_seq, (h_f, c_f) = jax_rnn.lstm_scan(
            gates, jnp.asarray(x["mask"]), w_in=None, b=None, w_rec=w,
            h0=h0, c0=c0, use_peephole=True, w_peep=peep,
            standard_acts=True)
        return (jnp.sum(h_seq * x["r_seq"]) + jnp.sum(h_f * x["r_h"])
                + jnp.sum(c_f * x["r_c"]))

    grads = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(x[k]) for k in _WRT))
    return [np.asarray(g) for g in grads]


def _torch_grads(x):
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in _WRT}
    h_seq, (h_f, c_f) = torch_rnn.lstm_scan(
        leaves["gates"], torch.from_numpy(x["mask"]), w_in=None, b=None,
        w_rec=leaves["w"], h0=leaves["h0"], c0=leaves["c0"],
        use_peephole=True, w_peep=leaves["peep"])
    loss = ((h_seq * torch.from_numpy(x["r_seq"])).sum()
            + (h_f * torch.from_numpy(x["r_h"])).sum()
            + (c_f * torch.from_numpy(x["r_c"])).sum())
    loss.backward()
    return [leaves[k].grad.numpy() for k in _WRT]


@pytest.mark.parametrize("hidden", [64, 256], ids=["resident_K2",
                                                   "tiled_K4"])
def test_lstm_scan_grads_match_jax_grad_of_fused_path(hidden, interpret,
                                                      monkeypatch):
    """The port's lstm_scan gradients (through LstmSeq on the CPU) against
    jax.grad of the JAX lstm_scan on the fused (Pallas, interpret) path;
    the plain backward ran once and nothing else differentiated the scan."""
    calls = []
    plain = lk.lstm_seq_bwd_reference

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(lk, "lstm_seq_bwd_reference", counted)
    x = _scan_inputs(hidden, seed=hidden + 1)
    got = _torch_grads(x)
    assert calls == [(T, B, 4 * hidden)]
    for name, g, w in zip(_WRT, got, _jax_grads(x)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def test_kernel_branch_gradients_come_only_from_the_function(monkeypatch):
    """With the plain backward stubbed out, the scan's kernel branch yields
    the stub's gradients: no other route (autograd through the plain
    forward loop) reaches the inputs."""
    x = _scan_inputs(8, seed=9)

    def stub(gates_tm, mask_tm, w_rec, peep, hprev, cprev, c_seq, dh_seq,
             dh_f, dc_f):
        return (torch.full_like(gates_tm, 2.0), torch.full_like(dh_f, 3.0),
                torch.full_like(dc_f, 4.0), torch.full_like(peep, 5.0))

    monkeypatch.setattr(lk, "lstm_seq_bwd_reference", stub)
    gates, w, peep, h0, c0 = _torch_grads(x)
    assert np.all(gates == 2.0) and np.all(h0 == 3.0) and np.all(c0 == 4.0)
    assert np.all(peep == 5.0)
    # dW is hprev^T . dgates outside the kernel: every column 2 * sum(hprev)
    h_seq, _ = lk.lstm_seq_fwd_reference(*(torch.from_numpy(a) for a in (
        x["gates"].transpose(1, 0, 2).copy(), x["mask"].T.copy(), x["w"],
        x["peep"].reshape(3, 8), x["h0"], x["c0"])))
    hprev = np.concatenate([x["h0"][None], h_seq[:-1].numpy()])
    want = np.repeat(2.0 * hprev.reshape(-1, 8).sum(0)[:, None], 32, axis=1)
    np.testing.assert_allclose(w, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8, 64, 128])
@pytest.mark.parametrize("hidden", [40, 256, 1280])
def test_bwd_plan_layouts_at_the_lstm_shapes(dtype, batch, hidden):
    """The backward's planner: clusters below H=512 (K2 at the flagship's
    256: one cluster of 8 blocks per batch tile, 5 rows per block at B=64
    so that its 13 clusters are co-resident on an H100 (which holds 15), 1
    row at B=1 and 8, 8 rows at B=128; the test width 40: clusters of 2, 2
    and 4 rows at B=64 and 128);
    at H=1280 (K4, the
    wide row) W tiles of 160 units x 320 gate columns, 8 x 16 = 128 blocks
    (one per SM), at most 64 rows per launch (128 rows as two launches), the
    tile resident in shared memory in bfloat16 (128 KB) and streamed from
    L2 in float32, (D) on the tensor cores in bfloat16 launches of more
    than 8 rows, and every block's shared memory within the card's 227
    KB."""
    plan = lk.bwd_plan(batch, hidden, dtype)
    assert plan == lk.bwd_plan(batch, hidden, dtype)
    if hidden < 512:
        # 15 clusters of 8 blocks at once on an H100, 60 of 2
        rows = ({1: 1, 8: 1, 64: 5, 128: 8} if hidden == 256
                else {1: 1, 8: 1, 64: 2, 128: 4})[batch]
        esz = 4 if dtype == torch.float32 else 2
        assert plan == {"layout": "cluster", "code": 2,
                        "rows_per_block": rows,
                        "cluster_size": -(-hidden // 32),
                        "clusters": -(-batch // rows),
                        "smem_bytes": lk._cl_smem(hidden, rows, esz)}
        assert plan["smem_bytes"] <= 232448
        return
    assert plan["layout"] == "w_tiles" and plan["code"] == 1
    assert (plan["units"], plan["cols"]) == (160, 320)
    assert (plan["unit_tiles"], plan["col_tiles"]) == (8, 16)
    assert plan["unit_tiles"] * plan["units"] >= hidden
    assert plan["col_tiles"] * plan["cols"] >= 4 * hidden
    assert plan["rows_per_launch"] == min(batch, 64)
    assert -(-batch // plan["rows_per_launch"]) == (2 if batch == 128 else 1)
    assert plan["resident"] == (dtype == torch.bfloat16)
    assert plan["dh_path"] == ("tc_bf16" if dtype == torch.bfloat16
                               and plan["rows_per_launch"] > 8
                               else "simt_f32")
    esz = 4 if dtype == torch.float32 else 2
    assert lk._wt_smem(plan["units"], plan["cols"], plan["rows_per_launch"],
                       esz, plan["resident"]) <= 232448


def _check_w_tiles(plan, batch, hidden, dtype, sms, smem):
    """A W-tile plan covers W with at most ``sms`` tiles of 32 x 2, 5 or 8
    units and a multiple of 32 gate columns, holds each launch's pairs
    within 4 per thread slot, and fits each block in ``smem`` bytes; a
    unit-tile plan only where no tiling fits at one row per warp."""
    esz = 4 if dtype == torch.float32 else 2
    if plan["layout"] == "unit_tiles":
        for per_lane in (2, 5, 8):
            ku = -(-hidden // (32 * per_lane))
            if ku > sms:
                continue
            cols = 32 * -(-4 * hidden // (32 * (sms // ku)))
            assert lk._wt_smem(32 * per_lane, cols, 1, esz, False) > smem
        return
    assert plan["units"] // 32 in (2, 5, 8) and plan["cols"] % 32 == 0
    assert plan["unit_tiles"] * plan["col_tiles"] <= sms
    assert plan["unit_tiles"] * plan["units"] >= hidden
    assert plan["col_tiles"] * plan["cols"] >= 4 * hidden
    rows = plan["rows_per_launch"]
    assert 1 <= rows <= min(batch, 64)
    assert rows * hidden <= 4 * 256 * plan["unit_tiles"] * plan["col_tiles"]
    assert lk._wt_smem(plan["units"], plan["cols"], rows, esz,
                       plan["resident"]) <= smem
    assert plan["dh_path"] == ("tc_bf16" if esz == 2 and rows > 8
                               else "simt_f32")


@pytest.mark.parametrize("hidden", [512, 1000, 2048, 3200, 4096, 8192])
def test_bwd_plan_w_tiles_cover_w_and_fit(hidden):
    """W tiles at other widths, up to those where a float32 tile of 2 units
    per lane fits no row count (H=3200: 50 x 2 tiles of 6400 columns) and
    where none fits (float32 at H=8192: unit tiles): every plan ends, and
    is a W-tile plan that covers W and fits (_check_w_tiles) or unit tiles
    where no W tile fits."""
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 8, 64, 128):
            plan = lk.bwd_plan(batch, hidden, dtype)
            assert plan == lk.bwd_plan(batch, hidden, dtype)
            _check_w_tiles(plan, batch, hidden, dtype, 132, 232448)
            if hidden <= 4096:
                assert plan["layout"] == "w_tiles"
    assert lk.bwd_plan(64, 8192, torch.float32)["layout"] == "unit_tiles"


@pytest.mark.parametrize("sms,smem", [(114, 232448), (108, 166912),
                                      (80, 101376)])
@pytest.mark.parametrize("hidden", [512, 1280, 3200])
def test_bwd_plan_follows_the_cards_limits(sms, smem, hidden):
    """The planner sizes the tiles by the card's SM count and shared memory
    per block (an H100 PCIe's 114 SMs, an A100's 108 and 163 KB, a smaller
    card's 99 KB), not by an H100's."""
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (8, 64):
            plan = lk.bwd_plan(batch, hidden, dtype, sms, smem)
            _check_w_tiles(plan, batch, hidden, dtype, sms, smem)


def test_bwd_plan_constants_match_the_kernel():
    """The planner's copy of the W-tile layout's constants equals the
    kernel's (csrc/lstm_seq_bwd.cu), so that a change on one side cannot
    leave the other planning another layout."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(lk.__file__), os.pardir, "csrc",
                            "lstm_seq_bwd.cu")).read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1))

    assert const("kWtChunk") == lk._BWD_CHUNK
    assert const("kWtStages") == lk._BWD_STAGES
    assert const("kWtPairs") == lk._BWD_PAIRS
    assert const("kWarps") == lk._BWD_WARPS
    # the units per lane the kernel is compiled for (wt_kernel_uj's cases)
    body = src[src.index("void* wt_kernel_uj("):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", body)) + (8,) \
        == lk._BWD_UNITS_PER_LANE
    assert "wt_kernel_res<T, R, 8>" in body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [36, 100, 250, 508])
def test_bwd_plan_unit_tiles_where_h_is_not_a_multiple_of_8(dtype, hidden):
    """The recompute pass and the cluster layout take H % 8 == 0 only; the
    planner keeps unit tiles at every other width below the W tiles'."""
    for batch in (1, 8, 64):
        assert lk.bwd_plan(batch, hidden, dtype) == {"layout": "unit_tiles",
                                                     "code": 0}
        assert lk.cluster_plan(batch, hidden, dtype) is None


@pytest.mark.parametrize("batch", [1, 64])
def test_bwd_plan_unit_tiles_where_a_cluster_does_not_fit(batch):
    """Unit tiles where the cluster layout cannot hold the width: W's row
    slice of a float32 block at H=488 (16 blocks) exceeds an H100's 227 KB
    (in bfloat16 it fits); 17 or more unit tiles exceed a cluster (on a card
    whose W tiles start above that width); a card that offers no clusters
    of 16 leaves H=384 (12 blocks) to unit tiles; and a card of less shared
    memory leaves H=256 in float32 to unit tiles."""
    unit = {"layout": "unit_tiles", "code": 0}
    assert lk.bwd_plan(batch, 488, torch.float32) == unit
    assert lk.bwd_plan(batch, 488, torch.bfloat16)["layout"] == "cluster"
    assert lk.bwd_plan(batch, 544, torch.bfloat16, min_hidden=1024) == unit
    assert lk.bwd_plan(batch, 384, torch.float32)["layout"] == "cluster"
    assert lk.bwd_plan(batch, 384, torch.float32,
                       clusters=(16, 0)) == unit
    assert lk.bwd_plan(batch, 256, torch.float32, smem=101376) == unit
    assert lk.bwd_plan(batch, 256, torch.bfloat16,
                       smem=101376)["layout"] == "cluster"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [40, 96, 200, 256, 384, 480])
@pytest.mark.parametrize("batch", [1, 3, 8, 64, 128, 600])
def test_cluster_plan_rows_keep_the_batch_co_resident(dtype, hidden, batch):
    """The rows per block: the smallest of 1, 2, 4, 5, 8 whose clusters the
    card holds at once (15 clusters of 8 on an H100, twice as many of 4 or
    fewer blocks, 7 of 16 blocks), else the largest whose block fits;
    every plan's block fits in 227 KB."""
    plan = lk.cluster_plan(batch, hidden, dtype)
    esz = 4 if dtype == torch.float32 else 2
    tiles = -(-hidden // 32)
    if lk._cl_smem(hidden, 1, esz) > 232448:
        assert plan is None
        return
    slots = 15 * (8 // tiles) if tiles <= 8 else 7
    rows = plan["rows_per_block"]
    assert plan["cluster_size"] == tiles
    assert plan["clusters"] == -(-batch // rows)
    assert plan["smem_bytes"] == lk._cl_smem(hidden, rows, esz) <= 232448
    fits = [r for r in clusters.ROWS if lk._cl_smem(hidden, r, esz) <= 232448]
    co_resident = [r for r in fits if -(-batch // r) <= slots]
    assert rows == (co_resident[0] if co_resident else fits[-1])


# (B, H, rows per block the planner picks): every count the cluster
# kernel is compiled for, at an ordinary batch
ROWS_AT = [(8, 256, 1), (64, 40, 2), (200, 40, 4), (64, 256, 5),
           (128, 256, 8)]


@pytest.mark.parametrize("batch,hidden,rows", ROWS_AT)
def test_cluster_plan_reaches_every_compiled_row_count(batch, hidden, rows):
    """Every rows-per-block count the kernel is compiled for comes out of
    the planner at an ordinary batch, so the card tests reach each one
    through ``cluster_plan``; a width that is no multiple of 8 has no
    cluster plan."""
    assert sorted({r for _, _, r in ROWS_AT}) == list(clusters.ROWS)
    for dtype in (torch.float32, torch.bfloat16):
        plan = lk.cluster_plan(batch, hidden, dtype)
        assert plan["rows_per_block"] == rows
        assert plan["clusters"] == -(-batch // rows)
    assert lk.cluster_plan(batch, 100, torch.float32) is None


def _cluster_smem_from_source(path):
    """cl_smem_bytes of a csrc/*.cu, as a Python function of (hidden, rows,
    element bytes), from the C expression itself."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(lk.__file__), os.pardir, "csrc",
                            path)).read()
    body = src[src.index("constexpr int cl_smem_bytes("):]
    expr = body[body.index("return") + 6:body.index(";")]
    expr = expr.replace("static_cast<int>(sizeof(float))", "4")

    consts = {"round_up": lambda x, m: -(-x // m) * m, "kUnits": 32,
              "kWarps": 8, "kCols": 128,
              "kDzLd": 128 + int(re.search(
                  r"constexpr int kDzLd = kCols \+ (\d+);", src).group(1))}

    def evaluate(hidden, rows, esz):
        return eval("(%s)" % expr, dict(consts, hidden=hidden, rows=rows,
                                        elem_bytes=esz))
    return src, evaluate


def test_cluster_constants_match_the_kernel():
    """The planner's copy of the cluster layout's constants equals the
    kernel's (csrc/lstm_seq_bwd.cu, csrc/sm90_cluster.cuh): the cluster
    size limit, the portable size, the rows per block the kernel is
    compiled for, the units per block and warps, and the shared-memory
    formula (W's row slice, the double-buffered exchange buffers and the
    partial sums), evaluated from the C expression."""
    import os
    import re
    src, smem = _cluster_smem_from_source("lstm_seq_bwd.cu")
    assert int(re.search(r"constexpr int kClMaxTiles = (\d+);",
                         src).group(1)) == clusters.MAX_TILES
    assert int(re.search(r"constexpr int kUnits = (\d+);", src).group(1)) == 32
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) == 8
    hdr = open(os.path.join(os.path.dirname(lk.__file__), os.pardir, "csrc",
                            "sm90_cluster.cuh")).read()
    assert int(re.search(r"constexpr int kPortableClusterSize = (\d+);",
                         hdr).group(1)) == clusters.PORTABLE
    body = src[src.index("void* cl_kernel(int rows, int tiles)"):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", body)) + (8,) \
        == clusters.ROWS
    assert "cl_kernel_w<T, 8>" in body.split("default:")[1]
    assert "lstm_bwd_cluster<T, R, true>" in src
    # the card's limits are read for this file's own cluster kernel
    assert ("return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, "
            "device, out);" in src)
    assert "int lstm_seq_bwd_limits(int device, int* out)" in src
    # the exchange: each block's dz rows at kDzLd floats a row, its partial
    # sums for a group of 32 units stored into the group's block at
    # rcv[src], two buffers by step parity, summed there in rank order
    assert int(re.search(r"constexpr int kDzLd = kCols \+ (\d+);",
                         src).group(1)) + 128 == lk._CL_DZ_LD
    assert "float* rt = rcv + (t & 1) * hp * R;" in src
    assert ("float* dst = cluster.map_shared_rank(rt, grp) + src * R * kUnits;"
            in src)
    assert ("for (int k = 0; k < tiles; ++k) s += rt[(k * R + warp) * kUnits "
            "+ lane];" in src)
    for hidden in (40, 96, 200, 256, 384, 480):
        for rows in clusters.ROWS:
            for esz in (2, 4):
                assert smem(hidden, rows, esz) == lk._cl_smem(hidden, rows,
                                                              esz)


def test_bwd_plan_refuses_other_dtypes():
    with pytest.raises(Exception, match="float32 or bfloat16"):
        lk.bwd_plan(8, 1280, torch.float16)
