"""The recurrent forward kernels' planners (``lstm_kernels.fwd_plan``,
``gru_kernels.gru_fwd_plan``) and the constants they copy from
csrc/lstm_seq_fwd.cu, csrc/gru_seq_fwd.cu and csrc/fwd_cluster.cuh, on the
CPU.

The LSTM forward (K1/K3) runs in one of three layouts: "grid" from H=512
where a block's slice of W fits (W spread over the shared memory of one
persistent grid of one block per SM), "cluster" where the width takes it
(one thread-block cluster per batch tile), "unit_tiles" elsewhere. The
GRU forward (K5) has "cluster" and "unit_tiles". The kernels run only on
the card (tests/test_torch_kernels_cuda.py); on a CPU tensor the wrappers
run the plain versions whatever the plan, which tests/test_torch_lstm.py
and tests/test_torch_gru.py hold against the JAX package.
"""

import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import clusters
from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.ops import lstm_kernels as lk

SMEM = 232448  # an H100's opt-in shared memory per block
UNIT = {"layout": "unit_tiles", "code": 0}
DTYPES = [torch.float32, torch.bfloat16]


def _source(name):
    return open(os.path.join(os.path.dirname(lk.__file__), os.pardir, "csrc",
                             name)).read()


def _esz(dtype):
    return 4 if dtype == torch.float32 else 2


def _constant(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def _c_expr(src, signature):
    """The expression a one-statement C function returns, as Python: the
    casts of sizeof(float) read 4, ``ns::f`` reads ``ns_f``, ``c ? a : b``
    becomes ``(a if c else b)`` and integer division ``//``."""
    body = src[src.index(signature):]
    expr = body[body.index("return") + 6:body.index(";")]
    expr = " ".join(expr.replace("static_cast<int>(sizeof(float))",
                                 "4").replace("::", "_").split())
    return re.sub(r"(?<!/)/(?!/)", "//", _py(expr)).replace(
        "&&", " and ").replace("||", " or ")


def _py(expr):
    """C's conditional operator in ``expr`` as Python's, innermost
    parentheses first."""
    out, depth, start = "", 0, None
    for i, ch in enumerate(expr):
        if ch == "(":
            if depth == 0:
                start = i
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out += "(" + _py(expr[start + 1:i]) + ")"
                continue
        if depth == 0 and ch != ")":
            out += ch
    depth, q, col = 0, None, None
    for i, ch in enumerate(out):
        depth += 1 if ch == "(" else -1 if ch == ")" else 0
        if depth == 0 and ch == "?" and q is None:
            q = i
        elif depth == 0 and ch == ":" and q is not None and col is None:
            col = i
    if q is None:
        return out
    return "((%s) if (%s) else (%s))" % (out[q + 1:col], out[:q],
                                         out[col + 1:])


def _ru(x, m):
    return -(-x // m) * m


# ---------------------------------------------------------------- the LSTM

# (T, B, H) of chip_smoke.py's forward layout phase: the served flagship
# (H=256 at buckets 1, 8, 32), its trained shape, H=512, the wide model
# (H=1280) trained at B=64, and B=128 at H=1280
LSTM_SHAPES = [(64, 1, 256), (64, 8, 256), (64, 32, 256), (100, 64, 256),
               (100, 64, 512), (100, 64, 1280), (32, 128, 1280)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("steps,batch,hidden", LSTM_SHAPES)
def test_fwd_plan_at_the_served_and_trained_shapes(steps, batch, hidden,
                                                   dtype):
    """At an H100's defaults: clusters of 8 blocks at H=256 (the rows per
    block the fewest that keep the batch's clusters co-resident: 1, 1, 3,
    5 rows at B = 1, 8, 32, 64); in bfloat16 at H=512 clusters of 16; else
    from H=512 the grid, ceil(H / 132) units per block (4 at H=512, 10 at
    H=1280: 128 blocks), B=128 in one launch of two passes."""
    plan = lk.fwd_plan(batch, hidden, dtype)
    if hidden == 256:
        rows = {1: 1, 8: 1, 32: 3, 64: 5}[batch]
        assert plan == {"layout": "cluster", "code": 2,
                        "rows_per_block": rows, "cluster_size": 8,
                        "clusters": -(-batch // rows),
                        "smem_bytes": lk._fwd_cl_smem(256, rows,
                                                      _esz(dtype))}
        return
    if hidden == 512 and dtype == torch.bfloat16:
        # clusters of 16 blocks, W's fragments in shared memory (measured
        # faster than the grid there)
        assert plan == lk.fwd_cluster_plan(batch, hidden, dtype)
        assert plan["cluster_size"] == 16 and plan["rows_per_block"] == 8
        return
    units = {512: 4, 1280: 10}[hidden]
    assert plan == {"layout": "grid", "code": 1, "units": units,
                    "blocks": 128, "rows_per_launch": batch,
                    "passes": -(-batch // 64),
                    "smem_bytes": lk._gr_smem(hidden, units, _esz(dtype))}
    assert plan["smem_bytes"] <= SMEM


def test_grid_slice_fits_at_h1280_float32_and_not_beyond():
    """The wide model's float32 slice: 1280 x 40 values = 204,800 bytes,
    and with the staging ring 229,376 of the 232,448 an H100 offers. At
    H=1536 a block would hold 12 units: its float32 slice alone is 294,912
    bytes, and 12 units exceed the 10 a block takes in either dtype, so
    unit tiles run it."""
    assert 1280 * 40 * 4 == 204800
    assert lk._gr_smem(1280, 10, 4) == 204800 + 3 * 32 * 64 * 4 == 229376
    assert lk._gr_smem(1536, 12, 4) > SMEM
    for dtype in DTYPES:
        assert lk.grid_plan(64, 1536, dtype) is None
        assert lk.fwd_plan(64, 1536, dtype) == UNIT
        plan = lk.fwd_plan(64, 1280, dtype)
        assert plan["layout"] == "grid" and plan["smem_bytes"] <= SMEM


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,launches,rows", [(1, 1, 1), (64, 1, 64),
                                                 (65, 1, 65), (128, 1, 128),
                                                 (129, 2, 65), (600, 5, 120)])
def test_grid_plan_row_chunks(dtype, batch, launches, rows):
    """The grid serves at most 128 rows (two passes of 64) per launch: a
    larger batch runs as the fewest equal chunks."""
    plan = lk.grid_plan(batch, 1280, dtype)
    assert plan["rows_per_launch"] == rows
    assert -(-batch // rows) == launches
    assert plan["passes"] == -(-rows // 64) <= 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sms,hidden,units", [
    (132, 1280, 10), (128, 1280, 10), (132, 1000, 8), (132, 768, 6),
    (132, 512, 4), (132, 100, 2), (114, 1280, None), (132, 1400, None)])
def test_grid_plan_reads_the_sm_count(dtype, sms, hidden, units):
    """Units per block from the card's SM count, not a fixed 128 blocks:
    ceil(H / SMs) rounded up to even (a warp's two register tiles share
    two units), at most 10; a card of 114 SMs would need 12 at H=1280."""
    plan = lk.grid_plan(64, hidden, dtype, sms=sms)
    if units is None:
        assert plan is None
        return
    assert plan["units"] == units and plan["blocks"] == -(-hidden // units)
    assert plan["blocks"] <= sms and units % 2 == 0
    assert plan["smem_bytes"] == lk._gr_smem(hidden, units, _esz(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [40, 96, 200, 256, 320, 384, 512])
@pytest.mark.parametrize("batch", [1, 6, 64, 600])
def test_fwd_plan_clusters_where_they_run(dtype, hidden, batch):
    """Clusters (H % 8 == 0, at most 16 unit tiles, the block in the
    card's shared memory; the rows per block by clusters.cluster_rows over
    the forward's row counts), in float32 only up to 8 unit tiles (W's
    columns in registers); a float32 width above 256 goes to the grid
    from H=512, else to unit tiles."""
    plan = lk.fwd_plan(batch, hidden, dtype)
    cluster = lk.fwd_cluster_plan(batch, hidden, dtype)
    esz = _esz(dtype)
    tiles = -(-hidden // 32)
    fits = [r for r in clusters.FWD_ROWS
            if lk._fwd_cl_smem(hidden, r, esz) <= SMEM]
    if not fits:
        assert cluster is None and hidden == 512 and esz == 4
    else:
        slots = clusters.cluster_slots(hidden, (15, 7))
        co_resident = [r for r in fits if -(-batch // r) <= slots]
        assert cluster["cluster_size"] == tiles
        assert cluster["rows_per_block"] == (co_resident[0] if co_resident
                                             else fits[-1])
        assert cluster["smem_bytes"] <= SMEM
    if cluster is not None and (esz == 2 or tiles <= 8):
        assert plan == cluster
    elif hidden >= 512:
        assert plan["layout"] == "grid"
    else:
        assert plan == UNIT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [37, 100, 250, 300])
def test_fwd_plan_unit_tiles_where_h_is_not_a_multiple_of_8(dtype, hidden):
    for batch in (1, 8, 64):
        assert lk.fwd_plan(batch, hidden, dtype) == UNIT


def test_fwd_plan_min_hidden_and_card_limits():
    """``min_hidden`` moves the switch to the grid (where the cluster
    does not run); a card without
    clusters of 8 leaves H=256 to unit tiles; H=384 in float32 fits a
    cluster block of at most 4 rows (W in shared memory: 196,608 bytes),
    which the planner does not pick."""
    assert lk.fwd_plan(64, 384, torch.float32,
                       min_hidden=256)["layout"] == "grid"
    assert lk.fwd_plan(64, 256, torch.float32,
                       min_hidden=256)["layout"] == "cluster"
    assert lk.fwd_plan(64, 512, torch.float32,
                       min_hidden=1024) == UNIT
    assert lk.fwd_plan(64, 256, torch.float32, clusters=(0, 0)) == UNIT
    plan = lk.fwd_cluster_plan(64, 384, torch.float32)
    assert plan["layout"] == "cluster" and plan["rows_per_block"] == 4
    assert lk._fwd_cl_smem(384, 5, 4) > SMEM
    assert lk.fwd_plan(64, 384, torch.float32) == UNIT
    with pytest.raises(Exception, match="float32 or bfloat16"):
        lk.fwd_plan(8, 256, torch.float16)


# ----------------------------------------------------------------- the GRU

GRU_SHAPES = [(128, 1, 256), (128, 8, 256), (128, 32, 256), (128, 64, 256),
              (30, 64, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("steps,batch,hidden", GRU_SHAPES)
def test_gru_fwd_plan_at_the_tagger_and_encoder_shapes(steps, batch, hidden,
                                                       dtype):
    """The tagger's H=256 in clusters of 8 (1, 1, 3, 5 rows at B = 1, 8,
    32, 64: at most 13 clusters, one wave of the 15 an H100 holds). At the
    NMT encoder's H=512 the cluster layout takes the shape in clusters of
    16 (the most rows that fit: 5 in float32, where the slices take 192
    KB, and 8 in bfloat16), but B=64 needs 13 or 8 clusters of the 7 an
    H100 holds at once: a second wave, so the planner keeps unit tiles."""
    plan = gk.gru_fwd_plan(batch, hidden, dtype)
    cluster = gk.fwd_cluster_plan(batch, hidden, dtype)
    if hidden == 256:
        rows = {1: 1, 8: 1, 32: 3, 64: 5}[batch]
    else:
        rows = 5 if dtype == torch.float32 else 8
    assert cluster == {"layout": "cluster", "code": 2,
                       "rows_per_block": rows,
                       "cluster_size": -(-hidden // 32),
                       "clusters": -(-batch // rows),
                       "smem_bytes": gk._fwd_cl_smem(hidden, rows,
                                                     _esz(dtype))}
    assert cluster["smem_bytes"] <= SMEM
    one_wave = cluster["clusters"] <= clusters.cluster_slots(hidden, (15, 7))
    assert one_wave == (hidden == 256)
    assert plan == (cluster if one_wave else UNIT)


def test_gru_fwd_plan_shared_memory_accounting():
    """In float32 at H=512 the W_rz and W_c slices take 512 x 96 x 4 =
    196,608 bytes, and 5 rows fill the block to 227,648; 8 do not fit. A
    card without clusters of 16 cannot run H=512 in clusters, nor can any
    card widths that are no multiple of 8 or exceed 16 unit tiles."""
    assert gk._fwd_cl_smem(512, 5, 4) == (196608 + 2 * 5 * 520 * 4
                                          + 4 * 8 * 64 * 5) == 227648
    assert gk._fwd_cl_smem(512, 8, 4) > SMEM
    assert gk.fwd_cluster_plan(64, 512, torch.float32,
                               clusters=(15, 0)) is None
    # a card that held 13 clusters of 16 would run H=512 in clusters
    assert gk.gru_fwd_plan(64, 512, torch.float32,
                           clusters=(15, 13))["layout"] == "cluster"
    for hidden in (37, 100, 544, 1024):
        assert gk.fwd_cluster_plan(64, hidden, torch.float32) is None
        assert gk.gru_fwd_plan(64, hidden, torch.float32) == UNIT
    with pytest.raises(Exception, match="float32 or bfloat16"):
        gk.gru_fwd_plan(8, 256, torch.float16)


# ------------------------------------------------- constants and accounting

def test_fwd_cluster_constants_match_the_header():
    """clusters.py's copy of csrc/fwd_cluster.cuh: the register path's K
    (8 warps x 32 units), the row padding, the cluster size limit, the
    switch to W in shared memory above a portable cluster, and the scratch
    of one product."""
    src = _source("fwd_cluster.cuh")
    assert _constant(src, "kUnits") == 32 and _constant(src, "kWarps") == 8
    assert "constexpr int kRegK = kWarps * kUnits;" in src
    assert clusters.FWD_REG_K == 256
    assert _constant(src, "kXPad") == clusters.FWD_XPAD
    assert _constant(src, "kMaxTiles") == clusters.MAX_TILES
    assert "return tiles <= sm90::kPortableClusterSize;" in src
    assert "return reg_w(tiles) ? kRegK : tiles * kUnits;" in src
    assert "return k_len(tiles) + kXPad;" in src
    assert ("return reg_w(tiles) ? 0 : k_len(tiles) * nc * elem_bytes;"
            in src)
    expr = _c_expr(src, "constexpr int scratch_floats(")
    for nc in (32, 64, 128):
        for rows in clusters.FWD_ROWS:
            for esz in (2, 4):
                got = eval(expr, {"kWarps": 8, "nc": nc, "rows": rows,
                                  "elem_bytes": esz})
                assert got == clusters.fwd_scratch_floats(nc, rows, esz)


def _fwdcl_env():
    """fwd_cluster.cuh's helpers in Python, from clusters.py's copy."""
    return {"kUnits": 32, "kCols": 128, "kRzCols": 64,
            "fwdcl::w_bytes": clusters.fwd_w_bytes,
            "fwdcl::x_pitch": lambda t: (clusters.fwd_k_len(t)
                                         + clusters.FWD_XPAD),
            "fwdcl::scratch_floats": clusters.fwd_scratch_floats}


def _eval_smem(expr, env):
    return eval(expr, {k.replace("::", "_"): v for k, v in env.items()})


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fwd_cluster_smem_matches_the_kernel(kind):
    """The planners' cluster block sizes equal the kernels'
    cl_smem_bytes, evaluated from the C expression, and the rows per
    block and the kernel each file compiles are the planner's."""
    mod, name = (lk, "lstm_seq_fwd.cu") if kind == "lstm" else (
        gk, "gru_seq_fwd.cu")
    src = _source(name)
    expr = _c_expr(src, "constexpr int cl_smem_bytes(")
    for hidden in (40, 96, 200, 256, 384, 512):
        for rows in clusters.FWD_ROWS:
            for esz in (2, 4):
                env = dict(_fwdcl_env(), hidden=hidden, rows=rows,
                           elem_bytes=esz)
                assert (_eval_smem(expr, env)
                        == mod._fwd_cl_smem(hidden, rows, esz))
    body = src[src.index("void* cl_kernel(int rows, int tiles)"):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", body)) + (8,) \
        == clusters.FWD_ROWS
    assert "((rows < 1 || rows > 5) && rows != 8)" in src
    assert "cl_kernel_w<T, 8>" in body.split("default:")[1]
    assert ("return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, "
            "device, out);" in src)
    assert "int %s_limits(int device, int* out)" % name[:-3] in src


def test_grid_constants_and_smem_match_the_kernel():
    """The planner's copy of the grid layout (_GR_*) equals
    csrc/lstm_seq_fwd.cu's constants, and ``_gr_smem`` its gr_smem_bytes
    (with gr_wp and gr_nt), evaluated from the C expressions."""
    src = _source("lstm_seq_fwd.cu")
    assert _constant(src, "kGrRows") == lk._GR_ROWS
    assert _constant(src, "kGrMaxPasses") == lk._GR_MAX_PASSES
    assert _constant(src, "kGrMaxUnits") == lk._GR_MAX_UNITS
    assert _constant(src, "kGrStages") == lk._GR_STAGES
    assert _constant(src, "kGrKcF32") == lk._GR_KC[4]
    assert _constant(src, "kGrKcBf16") == lk._GR_KC[2]
    assert "constexpr int kGrLdBf16 = kGrRows + 8;" in src
    assert lk._GR_LD_BF16 == lk._GR_ROWS + 8
    assert "__launch_bounds__(32 * kGrMaxUnits, 1)" in src
    # the kernel refuses an odd unit count; the planner rounds up to even
    assert "units % 2 != 0" in src
    assert all(lk.grid_plan(8, h, torch.float32)["units"] % 2 == 0
               for h in (100, 512, 700, 1000, 1280))
    wp = _c_expr(src, "constexpr int gr_wp(")
    nt = _c_expr(src, "constexpr int gr_nt(")
    expr = _c_expr(src, "constexpr int gr_smem_bytes(")
    for hidden in (100, 512, 768, 1024, 1280, 1536, 2048):
        for units in (2, 4, 6, 8, 10, 12):
            for esz in (2, 4):
                env = {"kGrRows": 64, "kGrStages": 3, "kGrKcF32": 32,
                       "kGrKcBf16": 64, "kGrLdBf16": 72,
                       "round_up": _ru, "hidden": hidden, "units": units,
                       "elem_bytes": esz,
                       "gr_wp": lambda u: eval(wp, {"units": u}),
                       "gr_nt": lambda u: eval(nt, {"units": u})}
                got = eval(expr, env)
                assert got == lk._gr_smem(hidden, units, esz)


def test_fwd_wrappers_pass_the_plan_to_the_c_entries():
    """The C entries take the layout code and its tiling after the shape:
    (T, B, H, layout, units, rows) for the LSTM, (T, B, H, layout, rows)
    for the GRU; the codes are the planners'."""
    lsrc = _source("lstm_seq_fwd.cu")
    assert ("int steps, int batch, int hidden, int layout, int units,\n"
            "                 int rows, int device" in lsrc)
    gsrc = _source("gru_seq_fwd.cu")
    assert ("void* h_seq, void* rh, int steps, int batch, int hidden,\n"
            "                int layout, int rows, int device" in gsrc)
    assert lk.grid_plan(64, 1280, torch.float32)["code"] == 1
    assert lk.fwd_cluster_plan(64, 256, torch.float32)["code"] == 2
    assert gk.gru_fwd_plan(64, 256, torch.float32)["code"] == 2
    assert gk.fwd_cluster_plan(64, 512, torch.float32)["code"] == 2


# ----------------------------------------------------- the wrappers on a CPU

def _lstm_args(rng, steps=5, batch=3, hidden=16):
    lens = np.array([steps, 0, 1][:batch])
    mask = (np.arange(steps)[:, None] < lens[None, :]).astype(np.float32)
    return (torch.tensor(rng.randn(steps, batch, 4 * hidden) * 0.5,
                         dtype=torch.float32),
            torch.from_numpy(mask),
            torch.tensor(rng.randn(hidden, 4 * hidden) / 4.0,
                         dtype=torch.float32),
            torch.tensor(rng.randn(3, hidden) * 0.3, dtype=torch.float32),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=torch.float32),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=torch.float32))


def test_lstm_fwd_wrapper_on_cpu_runs_the_plain_version_whatever_the_plan():
    """On a CPU tensor ``plan`` is not read: the wrapper runs the plain
    version and launches nothing."""
    args = _lstm_args(np.random.RandomState(3))
    before = lk.launches
    want = lk.lstm_seq_fwd_reference(*args)
    for plan in (lk.grid_plan(3, 16, torch.float32),
                 lk.fwd_cluster_plan(3, 16, torch.float32), UNIT, None):
        got = lk.lstm_seq_fwd(*args, plan=plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert lk.launches == before


def test_gru_fwd_wrapper_on_cpu_runs_the_plain_version_whatever_the_plan():
    rng = np.random.RandomState(4)
    steps, batch, hidden = 5, 3, 16
    mask = (np.arange(steps)[:, None]
            < np.array([steps, 0, 1])[None, :]).astype(np.float32)
    args = (torch.tensor(rng.randn(steps, batch, 3 * hidden) * 0.5,
                         dtype=torch.float32),
            torch.from_numpy(mask),
            torch.tensor(rng.randn(hidden, 2 * hidden) / 4.0,
                         dtype=torch.float32),
            torch.tensor(rng.randn(hidden, hidden) / 4.0, dtype=torch.float32),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=torch.float32))
    before = gk.launches
    want = gk.gru_seq_fwd_reference(*args)
    for plan in (gk.gru_fwd_plan(batch, hidden, torch.float32), UNIT, None):
        assert torch.equal(gk.gru_seq_fwd(*args, plan=plan), want)
    assert gk.launches == before
