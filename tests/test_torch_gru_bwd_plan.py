"""The GRU backward's planner (``gru_kernels.gru_bwd_plan``) and the
constants it copies from csrc/gru_seq_bwd.cu, on the CPU.

The planner picks the layout of the backward kernel K6 from the shapes and
dtype: one thread-block cluster per batch tile where the cluster layout
takes the width (H % 8 == 0, at most 16 unit tiles, W_c's and W_rz's row
slices and the exchange buffers in the card's shared memory), unit tiles
elsewhere. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py); on a CPU tensor the wrapper runs the
plain version whatever the plan, which tests/test_torch_gru.py holds
against the JAX package.
"""

import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import clusters
from paddle_tpu_torch.ops import gru_kernels as gk

SMEM = 232448  # an H100's opt-in shared memory per block
UNIT = {"layout": "unit_tiles", "code": 0}


def _source(name):
    return open(os.path.join(os.path.dirname(gk.__file__), os.pardir, "csrc",
                             name)).read()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,rows", [(1, 1), (8, 1), (32, 4), (64, 5),
                                        (128, 8)])
def test_gru_bwd_plan_clusters_at_the_tagger_width(dtype, batch, rows):
    """The tagger's GRU (H=256, trained at B=64, served at 1-32): one
    cluster of 8 blocks per batch tile, the rows per block the fewest that
    keep the batch's clusters co-resident on an H100 (15 clusters of 8), 8
    at B=128 (16 clusters: the most rows a block takes); both W row slices
    resident (96 KB in float32)."""
    plan = gk.gru_bwd_plan(batch, 256, dtype)
    esz = 4 if dtype == torch.float32 else 2
    assert plan == {"layout": "cluster", "code": 2, "rows_per_block": rows,
                    "cluster_size": 8, "clusters": -(-batch // rows),
                    "smem_bytes": gk._cl_smem(256, rows, esz)}
    assert plan["smem_bytes"] <= SMEM
    assert gk._cl_smem(256, 1, esz) >= 96 * 256 * esz


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 5),
                                        (torch.bfloat16, 8)])
def test_gru_bwd_plan_clusters_of_16_at_the_nmt_width(dtype, rows):
    """The NMT encoder's width (H=512): 16 unit tiles, a non-portable
    cluster size an H100 offers (7 at once); no rows per block keep B=64
    in 7 clusters, so the most rows that fit: in float32 the row slices
    take 192 KB and 5 rows fill the 227 KB exactly, in bfloat16 8."""
    plan = gk.gru_bwd_plan(64, 512, dtype)
    assert plan["layout"] == "cluster" and plan["cluster_size"] == 16
    assert plan["rows_per_block"] == rows
    assert plan["smem_bytes"] <= SMEM
    # a card without clusters of 16 leaves this width to unit tiles
    assert gk.gru_bwd_plan(64, 512, dtype, clusters=(16, 0)) == UNIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [37, 100, 250, 500])
def test_gru_bwd_plan_unit_tiles_where_h_is_not_a_multiple_of_8(dtype,
                                                                 hidden):
    """The recompute GEMMs take H % 8 == 0 only: unit tiles elsewhere."""
    for batch in (1, 8, 64, 600):
        assert gk.gru_bwd_plan(batch, hidden, dtype) == UNIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [544, 768, 1024])
def test_gru_bwd_plan_unit_tiles_above_16_unit_tiles(dtype, hidden):
    """More than 16 unit tiles exceed a cluster: unit tiles."""
    for batch in (1, 64):
        assert gk.gru_bwd_plan(batch, hidden, dtype) == UNIT


def test_gru_bwd_plan_unit_tiles_where_the_slices_do_not_fit():
    """A card of less shared memory per block (99 KB) has no room beside
    the float32 row slices at H=256 (96 KB) for the buffers of even one
    row, nor for the slices at H=512 in either dtype; the bfloat16 slices
    at H=256 (48 KB) fit with 5 rows."""
    small = 101376
    assert gk.gru_bwd_plan(64, 512, torch.float32, smem=small) == UNIT
    assert gk.gru_bwd_plan(64, 512, torch.bfloat16, smem=small) == UNIT
    assert gk.gru_bwd_plan(64, 256, torch.float32, smem=small) == UNIT
    assert gk._cl_smem(256, 1, 4) > small
    plan = gk.gru_bwd_plan(64, 256, torch.bfloat16, smem=small)
    assert plan["layout"] == "cluster" and plan["rows_per_block"] == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [40, 96, 200, 256, 384, 512])
@pytest.mark.parametrize("batch", [1, 3, 6, 64, 600])
def test_gru_bwd_plan_rows_keep_the_batch_co_resident(dtype, hidden, batch):
    """The rows per block follow clusters.cluster_rows, as the LSTM's
    do: the smallest of 1, 2, 4, 5, 8 whose clusters the card holds at once,
    else the largest whose block fits."""
    plan = gk.gru_bwd_plan(batch, hidden, dtype)
    esz = 4 if dtype == torch.float32 else 2
    tiles = -(-hidden // 32)
    slots = 15 * (8 // tiles) if tiles <= 8 else 7
    fits = [r for r in clusters.ROWS if gk._cl_smem(hidden, r, esz) <= SMEM]
    co_resident = [r for r in fits if -(-batch // r) <= slots]
    assert plan["layout"] == "cluster"
    assert plan["rows_per_block"] == (co_resident[0] if co_resident
                                      else fits[-1])
    assert plan["clusters"] == -(-batch // plan["rows_per_block"])
    assert plan["cluster_size"] == tiles


# (B, H, rows per block the planner picks): every count the cluster
# kernel is compiled for, at an ordinary batch
ROWS_AT = [(8, 256, 1), (64, 40, 2), (200, 40, 4), (64, 256, 5),
           (128, 256, 8)]


@pytest.mark.parametrize("batch,hidden,rows", ROWS_AT)
def test_gru_bwd_plan_reaches_every_compiled_row_count(batch, hidden, rows):
    """Every rows-per-block count the kernel is compiled for comes out of
    the planner at an ordinary batch, so the card tests reach each one
    through ``gru_bwd_plan``."""
    assert sorted({r for _, _, r in ROWS_AT}) == list(clusters.ROWS)
    for dtype in (torch.float32, torch.bfloat16):
        plan = gk.gru_bwd_plan(batch, hidden, dtype)
        assert plan["rows_per_block"] == rows
        assert plan["clusters"] == -(-batch // rows)


def test_gru_bwd_plan_refuses_other_dtypes():
    with pytest.raises(Exception, match="float32 or bfloat16"):
        gk.gru_bwd_plan(8, 256, torch.float16)


def test_gru_cluster_constants_match_the_kernel():
    """The planner's copy of the GRU cluster layout equals the kernel's
    (csrc/gru_seq_bwd.cu): the cluster size limit, the rows per block the
    kernel is compiled for, the layout of both exchange buffers, and the
    shared-memory formula, evaluated from the C expression."""
    src = _source("gru_seq_bwd.cu")
    assert int(re.search(r"constexpr int kClMaxTiles = (\d+);",
                         src).group(1)) == clusters.MAX_TILES
    body = src[src.index("void* cl_kernel(int rows, int tiles)"):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", body)) + (8,) \
        == clusters.ROWS
    assert "cl_kernel_w<T, 8>" in body.split("default:")[1]
    assert "gru_bwd_cluster<T, R, true>" in src
    # the card's limits are read for this file's own cluster kernel
    assert ("return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, "
            "device, out);" in src)
    assert "int gru_seq_bwd_limits(int device, int* out)" in src
    # dzc: row r, unit i at x1[r * x1p + i]; [dzu, dzr] of row r, unit k
    # as one vector at x2[r * x2p + 2k]; both in float32, rows padded by
    # kXPad floats
    assert "float* slot = x1 + warp * x1p + u;" in src
    assert "float* slot = x2 + warp * x2p + 2 * u;" in src
    assert "const int x1p = hidden + cl_xpad(hidden);" in src
    assert "const int x2p = 2 * hidden + cl_xpad(hidden);" in src
    assert ("return hidden <= sm90::kPortableClusterSize * kUnits ? kXPad : 0;"
            in src)
    pad = int(re.search(r"constexpr int kXPad = (\d+);", src).group(1))
    assert pad == gk._CL_XPAD
    cl = src[src.index("constexpr int cl_smem_bytes("):]
    expr = cl[cl.index("return") + 6:cl.index(";")]
    expr = expr.replace("static_cast<int>(sizeof(float))", "4")
    for hidden in (40, 96, 200, 256, 384, 512):
        for rows in clusters.ROWS:
            for esz in (2, 4):
                got = eval("(%s)" % expr, {
                    "round_up": lambda x, m: -(-x // m) * m, "kUnits": 32,
                    "kWarps": 8, "cl_xpad": lambda h: pad if h <= 256 else 0,
                    "hidden": hidden, "rows": rows, "elem_bytes": esz})
                assert got == gk._cl_smem(hidden, rows, esz)


def test_gru_bwd_wrapper_on_cpu_runs_the_plain_version_whatever_the_plan():
    """On a CPU tensor ``plan`` is not read: the wrapper runs the plain
    version and launches nothing."""
    rng = np.random.RandomState(5)
    steps, batch, hidden = 5, 3, 16
    lens = np.array([steps, 0, 1])
    mask = (np.arange(steps)[:, None] < lens[None, :]).astype(np.float32)
    args = (torch.tensor(rng.randn(steps, batch, 3 * hidden) * 0.5,
                         dtype=torch.float32),
            torch.from_numpy(mask),
            torch.tensor(rng.randn(hidden, 2 * hidden) / 4.0,
                         dtype=torch.float32),
            torch.tensor(rng.randn(hidden, hidden) / 4.0, dtype=torch.float32),
            torch.tensor(np.tanh(rng.randn(steps, batch, hidden)),
                         dtype=torch.float32),
            torch.tensor(rng.randn(steps, batch, hidden) * 0.5,
                         dtype=torch.float32),
            torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=torch.float32))
    before = gk.bwd_launches
    want = gk.gru_seq_bwd_reference(*args)
    for plan in (gk.gru_bwd_plan(batch, hidden, torch.float32), UNIT):
        got = gk.gru_seq_bwd(*args, plan=plan)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert gk.bwd_launches == before
