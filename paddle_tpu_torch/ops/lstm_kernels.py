"""Whole-sequence LSTM forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the autograd Function that joins them.

``lstm_seq_fwd`` has the function and contract of paddle_tpu/ops/
pallas_kernels.py ``lstm_fused`` forward (the TPU kernels K1
``_lstm_fwd_kernel`` and K3 ``_lstm_fwd_tiled_kernel``):

    gates_tm [T, B, 4H]  x.W_in + b, gate order i, f, g, o (f32 or bf16)
    mask_tm  [T, B]      f32; 0 = padded step, state copied forward
    w_rec    [H, 4H]     gates' dtype
    peep     [3, H]      f32 peephole checks (zeros = plain LSTM)
    h0, c0   [B, H]      gates' dtype
    -> h_seq, c_seq [T, B, H] in the gates' dtype; c is carried in f32.

On a CUDA tensor the wrapper launches the kernel (paddle_tpu_torch/csrc/
lstm_seq_fwd.cu) in one of three layouts that ``fwd_plan`` picks from the
shapes and dtype: "cluster" (H % 8 == 0 up to 16 unit tiles, in float32
up to 8: one thread-block cluster per batch tile, each block's W columns
on chip, h_t exchanged through distributed shared memory behind one
cluster barrier a step), "grid" (512 <= H <= 1320 on an H100 where the
cluster does not run: W spread over the shared memory of one persistent
grid of one block per SM, each block U units for every row, h_{t-1}
streamed from L2 each step, one grid barrier a step; batches above 128
rows as equal row chunks, one launch each) or "unit_tiles" (what neither
takes: blocks of 32 units x R rows, one cooperative launch per row chunk
that fits, a grid barrier a step); each launch is counted. On a CPU
tensor it runs ``lstm_seq_fwd_reference``, the plain loop of the same
function, which is also the oracle the kernel is held against.

``lstm_seq_bwd`` has the function and contract of the backward kernels K2
``_lstm_bwd_kernel`` and K4 ``_lstm_bwd_tiled_kernel`` (pallas_kernels.py
``_vjp_bwd``): from the saved forward (hprev = [h0, h_seq[:-1]], cprev =
[c0, c_seq[:-1]], c_seq) and the cotangents (dh_seq [T, B, H], dh_f, dc_f
[B, H]) it gives dgates [T, B, 4H] and dh0, dc0 [B, H] in the gates' dtype
and dpeep [3, H] in float32. Its kernel is csrc/lstm_seq_bwd.cu, in one
of three layouts that ``bwd_plan`` picks from the shapes and dtype:
"cluster" (H % 8 == 0 up to 512 units: a recompute pass of z for all
steps, then one thread-block cluster per batch tile, its blocks the unit
tiles, each step's dz exchanged through distributed shared memory behind
one cluster barrier), "w_tiles" (H >= 512: W cut into a grid of unit x
gate-column tiles, each serving every row, after the same recompute pass;
in bfloat16 each step's dz . W^T runs on the tensor cores) or
"unit_tiles" (what neither takes: each block a slice of units x rows, W
slices per block, a grid barrier a step); on a CPU tensor it runs
``lstm_seq_bwd_reference``.

``LstmSeq`` is the autograd Function around the pair (the JAX package's
``lstm_fused`` custom VJP): its forward is ``lstm_seq_fwd``, its backward
``lstm_seq_bwd`` plus the weight gradient hprev^T . dgates as one matmul
outside the kernel. It runs the same way on both devices, so the CPU tests
exercise the backward the card runs, not autograd through the plain loop.
"""

import threading

import torch

from paddle_tpu_torch.ops import clusters as cl
from paddle_tpu_torch.ops._build import H100_SMS, aligned, check_args, launch
from paddle_tpu_torch.utils.error import enforce

# kernel launches since the last reset, forward (``launches``) and backward
# (``bwd_launches``) apart (a launch made to compare a kernel with its plain
# version counts too; callers reset around the path they read)
launches = 0
bwd_launches = 0
_count_lock = threading.Lock()


def reset_launches():
    global launches, bwd_launches
    with _count_lock:
        launches = 0
        bwd_launches = 0


def _count_launches(n):
    global launches
    with _count_lock:
        launches += n


def _count_bwd_launches(n):
    global bwd_launches
    with _count_lock:
        bwd_launches += n


# The backward's W-tile layout (csrc/lstm_seq_bwd.cu), for H >= 512 with
# H % 8 == 0: tiles of ``units`` (32 x 2, 5 or 8: the kernel is compiled
# for these units per lane) x ``cols`` (a multiple of 32) of W [H, 4H], one
# block each, at most one block per SM; at most 64 rows per launch (8 warps
# of 1 or 8 rows) and 4 (row, unit) pairs per thread slot of the grid's
# 256-thread blocks. These constants and ``_wt_smem`` copy the kernel's
# (kWtChunk, kWtStages, kWtPairs, kWarps, wt_smem_bytes);
# tests/test_torch_lstm_bwd.py holds the two equal. The card's SM count
# and shared memory per block come from the card (``device_limits``); the
# defaults are an H100's, which the CPU tests plan for.
_BWD_MIN_HIDDEN = 512
_BWD_WARPS = 8
_BWD_MAX_ROWS = 8 * _BWD_WARPS
_BWD_THREADS = 32 * _BWD_WARPS
_BWD_PAIRS = 4
_BWD_CHUNK = 32
_BWD_STAGES = 3
_BWD_UNITS_PER_LANE = (2, 5, 8)


def _wt_smem(units, cols, rows, esz, resident):
    """Shared memory of a W-tile block, in the gates' dtype: the W tile
    (all its 32-column chunks, or a 3-chunk ring) at a pitch of 32 + 16/esz
    elements, and the staged dz rows (8 warps x 1 or 8 rows, pitch cols +
    16/esz)."""
    per_warp = 1 if rows <= _BWD_WARPS else 8
    chunks = cols // _BWD_CHUNK if resident else _BWD_STAGES
    return esz * (chunks * units * (_BWD_CHUNK + 16 // esz)
                  + _BWD_WARPS * per_warp * (cols + 16 // esz))


def device_limits(dev):
    """(SM count, opt-in shared memory per block in bytes, (clusters of 8,
    clusters of 16)) of the card ``dev``, as the kernel's C side reads them
    for its cluster kernel (``clusters.device_limits``)."""
    return cl.device_limits("lstm_seq_bwd", dev)


# The cluster layout (``clusters``): W's column slice resident, dz rows and
# the received partial sums in float32. These constants and ``_cl_smem``
# copy the kernel's (kDzLd, cl_smem_bytes); tests/test_torch_lstm_bwd.py
# holds the two equal.
_CL_DZ_LD = 136  # floats per local dz row: 4 x 32 columns and 8 of padding


def _cl_smem(hidden, rows, esz):
    """Shared memory of an LSTM cluster block: W's column slice [128][H
    rounded up to 32] in the gates' dtype (rounded up to 16 bytes), then
    the block's dz rows [R][136] and the partial sums it receives
    [2][tiles][R][32] in float32."""
    hp = -(-hidden // 32) * 32
    return (-(-128 * hp * esz // 16) * 16 + 4 * rows * _CL_DZ_LD
            + 8 * hp * rows)


def cluster_plan(batch, hidden, dtype, smem=cl.H100_SMEM_OPTIN,
                 clusters=cl.H100_CLUSTERS):
    """The LSTM backward's cluster layout for this shape (rows per block by
    ``clusters.cluster_rows``), or None where it does not take it."""
    esz = 4 if dtype == torch.float32 else 2
    rows = cl.cluster_rows(batch, hidden, lambda r: _cl_smem(hidden, r, esz),
                           smem, clusters)
    if rows is None:
        return None
    return {"layout": "cluster", "code": 2, "rows_per_block": rows,
            "cluster_size": -(-hidden // 32), "clusters": -(-batch // rows),
            "smem_bytes": _cl_smem(hidden, rows, esz)}


def bwd_plan(batch, hidden, dtype, sms=H100_SMS, smem=cl.H100_SMEM_OPTIN,
             clusters=cl.H100_CLUSTERS, min_hidden=_BWD_MIN_HIDDEN):
    """The LSTM backward's layout for a batch of ``batch`` rows at
    ``hidden`` units in ``dtype`` on a card of ``sms`` SMs, ``smem`` bytes
    of shared memory per block and ``clusters`` (``device_limits``), from
    the shapes and dtype alone:
    "w_tiles" with ``units`` x ``cols`` per tile (the fewest multiply-adds
    per block, summed over the launches, among tilings of at most ``sms``
    tiles), the tile grid, ``rows_per_launch`` (equal chunks of at most 64
    rows), ``resident`` (the tile stays in shared memory; else it streams
    from L2 once per step) and ``dh_path``, the product of (D): "tc_bf16"
    (tensor cores: bfloat16 at more than 8 rows per launch) or "simt_f32",
    for H >= ``min_hidden`` with H % 8 == 0 where a tiling's block fits in
    ``smem`` at one row (f32 below H=3200 on an H100);
    below that width, "cluster" (``cluster_plan``) where it takes the
    shape; else "unit_tiles" (the kernel then picks its grid and W
    placement itself)."""
    enforce(dtype in (torch.float32, torch.bfloat16), "lstm_seq_bwd takes "
            "float32 or bfloat16 inputs, got %s", dtype)
    unit_tiles = {"layout": "unit_tiles", "code": 0}
    if hidden < min_hidden or hidden % 8:
        return (cluster_plan(batch, hidden, dtype, smem, clusters)
                or unit_tiles)
    esz = 4 if dtype == torch.float32 else 2
    g4 = 4 * hidden
    best = None
    for per_lane in _BWD_UNITS_PER_LANE:
        units = 32 * per_lane
        ku = -(-hidden // units)
        if ku > sms:
            continue
        kc = sms // ku
        cols = 32 * -(-g4 // (32 * kc))
        kc = -(-g4 // cols)
        # the least shared memory a block of this tiling takes (one row per
        # warp): where even that does not fit, no row count does
        if _wt_smem(units, cols, 1, esz, False) > smem:
            continue
        # more launches of fewer rows until both the pair slots and the
        # staging fit; at 8 rows or fewer both do, so this ends
        launches = -(-batch // _BWD_MAX_ROWS)
        while True:
            rows = -(-batch // launches)
            if (rows * hidden <= _BWD_PAIRS * ku * kc * _BWD_THREADS
                    and _wt_smem(units, cols, rows, esz, False) <= smem):
                break
            launches += 1
        key = (launches * units * cols, ku * kc)
        if best is None or key < best[0]:
            best = (key, units, cols, ku, kc, rows)
    if best is None:
        return unit_tiles
    _, units, cols, ku, kc, rows = best
    return {"layout": "w_tiles", "code": 1, "units": units, "cols": cols,
            "unit_tiles": ku, "col_tiles": kc, "rows_per_launch": rows,
            "resident": _wt_smem(units, cols, rows, esz, True) <= smem,
            "dh_path": ("tc_bf16" if esz == 2 and rows > _BWD_WARPS
                        else "simt_f32")}


def fwd_device_limits(dev):
    """(SM count, opt-in shared memory per block in bytes, (clusters of 8,
    clusters of 16)) of the card ``dev``, as the forward kernel's C side
    reads them for its cluster kernel (``clusters.device_limits``)."""
    return cl.device_limits("lstm_seq_fwd", dev)


def _fwd_cl_smem(hidden, rows, esz):
    """Shared memory of an LSTM forward cluster block (csrc/lstm_seq_fwd.cu
    cl_smem_bytes): W's 128 columns where they are not in registers, h_{t-1}
    of the block's rows in two parities, and the product's scratch."""
    tiles = -(-hidden // 32)
    return (cl.fwd_w_bytes(tiles, 128, esz)
            + cl.fwd_state_bytes(tiles, rows, 2)
            + 4 * cl.fwd_scratch_floats(128, rows, esz))


def fwd_cluster_plan(batch, hidden, dtype, smem=cl.H100_SMEM_OPTIN,
                     clusters=cl.H100_CLUSTERS):
    """The LSTM forward's cluster layout for this shape (rows per block by
    ``clusters.cluster_rows``), or None where it does not take it."""
    esz = 4 if dtype == torch.float32 else 2
    rows = cl.cluster_rows(batch, hidden,
                           lambda r: _fwd_cl_smem(hidden, r, esz), smem,
                           clusters, cl.FWD_ROWS)
    if rows is None:
        return None
    return {"layout": "cluster", "code": 2, "rows_per_block": rows,
            "cluster_size": -(-hidden // 32), "clusters": -(-batch // rows),
            "smem_bytes": _fwd_cl_smem(hidden, rows, esz)}


# The grid layout (csrc/lstm_seq_fwd.cu, kGr*): ceil(H / SMs) units per
# block rounded up to even, one warp each (at most 10); passes of 64 rows,
# at most 2 per launch; h_{t-1} staged in K chunks (32 in float32, 64 in
# bfloat16) through a 3-slot ring. These constants and ``_gr_smem`` copy
# the kernel's; tests/test_torch_fwd_plan.py holds the two equal.
_GR_MIN_HIDDEN = 512
_GR_ROWS = 64
_GR_MAX_PASSES = 2
_GR_MAX_UNITS = 10
_GR_STAGES = 3
_GR_KC = {4: 32, 2: 64}
_GR_LD_BF16 = _GR_ROWS + 8


def _gr_smem(hidden, units, esz):
    """Shared memory of a grid block (csrc/lstm_seq_fwd.cu gr_smem_bytes):
    float32: W [K up to 32][4U, + 4 where U % 4 == 0] and the staging ring
    [3][32][64]; bfloat16: W's B fragments [K up to 64 / 16][ceil(U / 2)][32
    lanes] x 8 bytes, the ring [3][64][72] and the tile [64][8 ceil(U / 2)]
    in float32."""
    kc = _GR_KC[esz]
    kpad = -(-hidden // kc) * kc
    if esz == 4:
        wp = 4 * units + (4 if units % 4 == 0 else 0)
        return kpad * wp * 4 + _GR_STAGES * kc * _GR_ROWS * 4
    nts = -(-4 * units // 8)
    return (kpad // 16 * nts * 32 * 8 + _GR_STAGES * kc * _GR_LD_BF16 * 2
            + _GR_ROWS * nts * 8 * 4)


def grid_plan(batch, hidden, dtype, sms=H100_SMS, smem=cl.H100_SMEM_OPTIN):
    """The LSTM forward's grid layout for this shape on a card of ``sms``
    SMs and ``smem`` bytes of shared memory per block, or None where it
    does not take it (more than 10 units a block: above H=1320 on an H100;
    or a block's slice that does not fit): ``units`` = ceil(H / sms) per
    block rounded up to even, ``rows_per_launch`` the equal row chunks of
    at most 128 rows, ``passes`` of 64 rows per step."""
    esz = 4 if dtype == torch.float32 else 2
    units = -(-hidden // sms)
    units += units % 2
    if units > _GR_MAX_UNITS or _gr_smem(hidden, units, esz) > smem:
        return None
    launches = -(-batch // (_GR_ROWS * _GR_MAX_PASSES))
    rows = -(-batch // launches)
    return {"layout": "grid", "code": 1, "units": units,
            "blocks": -(-hidden // units), "rows_per_launch": rows,
            "passes": -(-rows // _GR_ROWS),
            "smem_bytes": _gr_smem(hidden, units, esz)}


def fwd_plan(batch, hidden, dtype, sms=H100_SMS, smem=cl.H100_SMEM_OPTIN,
             clusters=cl.H100_CLUSTERS, min_hidden=_GR_MIN_HIDDEN):
    """The LSTM forward's layout for a batch of ``batch`` rows at
    ``hidden`` units in ``dtype`` on a card of ``sms`` SMs, ``smem`` bytes
    of shared memory per block and ``clusters`` (``fwd_device_limits``),
    from the shapes and dtype alone: "cluster" (``fwd_cluster_plan``)
    where it takes the shape, in float32 only where W's columns sit in
    registers (H <= 256: with W in shared memory the float32 cluster loop
    loses to unit tiles at B=32); else "grid" (``grid_plan``) for H >=
    ``min_hidden`` where it fits; else "unit_tiles" (the kernel then picks
    its grid and W placement itself)."""
    enforce(dtype in (torch.float32, torch.bfloat16), "lstm_seq_fwd takes "
            "float32 or bfloat16 inputs, got %s", dtype)
    plan = fwd_cluster_plan(batch, hidden, dtype, smem, clusters)
    if plan is not None and (dtype == torch.bfloat16
                             or plan["cluster_size"] <= cl.PORTABLE):
        return plan
    if hidden >= min_hidden:
        plan = grid_plan(batch, hidden, dtype, sms, smem)
        if plan is not None:
            return plan
    return {"layout": "unit_tiles", "code": 0}


def lstm_seq_fwd_reference(gates_tm, mask_tm, w_rec, peep, h0, c0):
    """The plain PyTorch loop of the kernel's function (same dtype rules:
    f32 products and sums, c carried in f32, h rounded to the gates'
    dtype at every step)."""
    steps, _, g4 = gates_tm.shape
    hidden = g4 // 4
    dt = gates_tm.dtype
    w = w_rec.float()
    pi, pf, po = peep.float().reshape(3, hidden)
    h = h0.to(dt)
    c = c0.float()
    hs, cs = [], []
    for t in range(steps):
        z = gates_tm[t].float() + torch.matmul(h.float(), w)
        zi, zf, zg, zo = torch.split(z, hidden, dim=-1)
        i = torch.sigmoid(zi + c * pi)
        f = torch.sigmoid(zf + c * pf)
        g = torch.tanh(zg)
        c_new = f * c + i * g
        o = torch.sigmoid(zo + c_new * po)
        h_new = o * torch.tanh(c_new)
        m = (mask_tm[t] > 0)[:, None]
        h = torch.where(m, h_new.to(dt), h)
        c = torch.where(m, c_new, c)
        hs.append(h)
        cs.append(c.to(dt))
    return torch.stack(hs), torch.stack(cs)


def lstm_seq_bwd_reference(gates_tm, mask_tm, w_rec, peep, hprev_tm,
                           cprev_tm, c_seq, dh_seq, dh_f, dc_f):
    """The plain PyTorch reverse loop of the backward kernel's function
    (same dtype rules as pallas_kernels.py ``_lstm_bwd_kernel``: f32
    products and sums; tanh(c_t) from c_seq as stored, c_new recomputed in
    f32; dz rounded to the gates' dtype for dgates and before dz . W^T;
    dh0/dc0 in the gates' dtype, dpeep summed in f32)."""
    steps, _, g4 = gates_tm.shape
    hidden = g4 // 4
    dt = gates_tm.dtype
    w = w_rec.float()
    pi, pf, po = peep.float().reshape(3, hidden)
    dh = dh_f.float()
    dc = dc_f.float()
    dgates = torch.empty_like(gates_tm)
    dpeep = torch.zeros((3, hidden), dtype=torch.float32,
                        device=gates_tm.device)
    for t in range(steps - 1, -1, -1):
        c_prev = cprev_tm[t].float()
        z = gates_tm[t].float() + torch.matmul(hprev_tm[t].float(), w)
        zi, zf, zg, zo = torch.split(z, hidden, dim=-1)
        i = torch.sigmoid(zi + c_prev * pi)
        f = torch.sigmoid(zf + c_prev * pf)
        g = torch.tanh(zg)
        c_new = f * c_prev + i * g
        o = torch.sigmoid(zo + c_new * po)
        tc = torch.tanh(c_seq[t].float())
        m = (mask_tm[t] > 0)[:, None]
        dh_tot = dh_seq[t].float() + dh
        dh_eff = torch.where(m, dh_tot, 0.0)
        dzo = dh_eff * tc * o * (1.0 - o)
        # o's peephole reads c_t: its gradient feeds back into dc
        dc_eff = (torch.where(m, dc, 0.0) + dh_eff * o * (1.0 - tc * tc)
                  + dzo * po)
        dzi = dc_eff * g * i * (1.0 - i)
        dzf = dc_eff * c_prev * f * (1.0 - f)
        dzg = dc_eff * i * (1.0 - g * g)
        dz = torch.cat([dzi, dzf, dzg, dzo], dim=-1).to(dt)
        dgates[t] = dz
        dh = torch.where(m, 0.0, dh_tot) + torch.matmul(dz.float(), w.t())
        dc = dc_eff * f + dzi * pi + dzf * pf + torch.where(m, 0.0, dc)
        dpeep += torch.stack([(dzi * c_prev).sum(0), (dzf * c_prev).sum(0),
                              (dzo * c_new).sum(0)])
    return dgates, dh.to(dt), dc.to(dt), dpeep


def _gates_shape(gates_tm):
    """(T, B, H) of gates [T, B, 4H]."""
    enforce(gates_tm.dim() == 3 and gates_tm.shape[-1] % 4 == 0,
            "gates_tm must be [T, B, 4H], got %s", tuple(gates_tm.shape))
    steps, batch, g4 = gates_tm.shape
    return steps, batch, g4 // 4


def _check(gates_tm, mask_tm, w_rec, peep, h0, c0):
    steps, batch, hidden = _gates_shape(gates_tm)
    check_args("lstm_seq_fwd", gates_tm, (
        ("mask_tm", mask_tm, (steps, batch), torch.float32),
        ("w_rec", w_rec, (hidden, 4 * hidden), None),
        ("peep", peep, (3, hidden), torch.float32),
        ("h0", h0, (batch, hidden), None),
        ("c0", c0, (batch, hidden), None)))


def _check_bwd(gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
               dh_seq, dh_f, dc_f):
    steps, batch, hidden = _gates_shape(gates_tm)
    seq = (steps, batch, hidden)
    check_args("lstm_seq_bwd", gates_tm, (
        ("mask_tm", mask_tm, (steps, batch), torch.float32),
        ("w_rec", w_rec, (hidden, 4 * hidden), None),
        ("peep", peep, (3, hidden), torch.float32),
        ("hprev_tm", hprev_tm, seq, None),
        ("cprev_tm", cprev_tm, seq, None),
        ("c_seq", c_seq, seq, None),
        ("dh_seq", dh_seq, seq, None),
        ("dh_f", dh_f, (batch, hidden), None),
        ("dc_f", dc_f, (batch, hidden), None)))


def lstm_seq_fwd(gates_tm, mask_tm, w_rec, peep, h0, c0, plan=None):
    """Masked peephole-LSTM forward over the whole sequence (see module
    docstring). With ``plan=None`` the call goes through the registered
    op ``torch.ops.paddle_tpu_torch.lstm_seq_fwd`` (``lstm_seq_fwd_op``),
    which launches the kernel in ``fwd_plan``'s layout for this card on a
    CUDA tensor and runs the plain version on a CPU tensor; an exported
    program records that op. ``plan`` (a ``fwd_plan`` result) launches
    that layout directly instead. After a kernel call,
    ``lstm_seq_fwd.last_launch`` holds the plan, the grid the kernel chose
    and the number of launches it made."""
    args = (gates_tm, mask_tm, w_rec, peep, h0, c0)
    _check(*args)
    if plan is None:
        return tuple(lstm_seq_fwd_op(*args))
    if gates_tm.device.type == "cpu":
        return lstm_seq_fwd_reference(*args)
    return _launch_fwd(args, plan)


def _launch_fwd(args, plan):
    """One call of the forward kernel on checked inputs ``args`` (a CUDA
    tensor, else raises) in layout ``plan`` (None: ``fwd_plan``'s)."""
    gates_tm = args[0]
    dev = gates_tm.device
    enforce(dev.type == "cuda", "lstm_seq_fwd runs on cuda or cpu tensors, "
            "got %s", dev)
    steps, batch, hidden = _gates_shape(gates_tm)
    if plan is None:
        plan = fwd_plan(batch, hidden, gates_tm.dtype, *fwd_device_limits(dev))
    h_seq = torch.empty((steps, batch, hidden), dtype=gates_tm.dtype,
                        device=dev)
    c_seq = torch.empty_like(h_seq)
    if plan["layout"] == "grid":
        # h of every unit, unit-major: [2][H][64 per pass]
        hbuf = torch.empty((2, hidden, _GR_ROWS * plan["passes"]),
                           dtype=gates_tm.dtype, device=dev)
        tiling = (plan["units"], plan["rows_per_launch"])
    elif plan["layout"] == "cluster":
        hbuf = torch.empty((0,), dtype=gates_tm.dtype, device=dev)
        tiling = (0, plan["rows_per_block"])
    else:
        hbuf = torch.empty((2, batch, hidden), dtype=gates_tm.dtype,
                           device=dev)
        tiling = (0, 0)
    info = launch("lstm_seq_fwd", dev, tuple(aligned(a) for a in args),
                  (h_seq, c_seq, hbuf),
                  (steps, batch, hidden, plan["code"]) + tiling,
                  _count_launches)
    lstm_seq_fwd.last_launch = dict(plan, **dict(zip(
        ("blocks", "rows_per_block", "w_placement", "smem_bytes",
         "rows_per_launch", "launches"), info)))
    return h_seq, c_seq


@torch.library.custom_op("paddle_tpu_torch::lstm_seq_fwd", mutates_args=(),
                         device_types="cpu")
def lstm_seq_fwd_op(gates_tm: torch.Tensor, mask_tm: torch.Tensor,
                    w_rec: torch.Tensor, peep: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as a registered op (K1/K3): the plain version on the
    CPU, the kernel on the card (``_launch_fwd``, which counts the
    launches), the output shapes alone while a program is traced."""
    return lstm_seq_fwd_reference(gates_tm, mask_tm, w_rec, peep, h0, c0)


@lstm_seq_fwd_op.register_kernel("cuda")
def _lstm_seq_fwd_cuda(gates_tm, mask_tm, w_rec, peep, h0, c0):
    return _launch_fwd((gates_tm, mask_tm, w_rec, peep, h0, c0), None)


@lstm_seq_fwd_op.register_fake
def _lstm_seq_fwd_fake(gates_tm, mask_tm, w_rec, peep, h0, c0):
    steps, batch, hidden = _gates_shape(gates_tm)
    h_seq = gates_tm.new_empty((steps, batch, hidden))
    return h_seq, torch.empty_like(h_seq)


lstm_seq_fwd.last_launch = None


def lstm_seq_bwd(gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
                 dh_seq, dh_f, dc_f, plan=None):
    """Masked peephole-LSTM backward over the whole sequence (see module
    docstring): -> dgates [T, B, 4H], dh0, dc0 [B, H], dpeep [3, H] f32.
    On a CUDA tensor ``plan`` is the layout to run (a ``bwd_plan`` result;
    None: ``bwd_plan``'s choice for this card). After a kernel call,
    ``lstm_seq_bwd.last_launch`` holds the plan, the grid the kernel chose
    and the number of launches it made."""
    args = (gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
            dh_seq, dh_f, dc_f)
    _check_bwd(*args)
    dev = gates_tm.device
    if dev.type == "cpu":
        return lstm_seq_bwd_reference(*args)
    enforce(dev.type == "cuda", "lstm_seq_bwd runs on cuda or cpu tensors, "
            "got %s", dev)
    return _launch_bwd(args, plan)[0]


def _launch_bwd(args, plan):
    """One call of the backward kernel on checked CUDA inputs ``args``:
    ((dgates, dh0, dc0, dpeep), zbuf), the float32 workspace as the call
    leaves it (clusters and W tiles: z [T, B, 4H] of every step, as the
    recompute pass wrote it)."""
    gates_tm, w_rec = args[0], args[2]
    dev = gates_tm.device
    steps, batch, g4 = gates_tm.shape
    hidden = g4 // 4
    dgates = torch.empty_like(gates_tm)
    dh0 = torch.empty((batch, hidden), dtype=gates_tm.dtype, device=dev)
    dc0 = torch.empty_like(dh0)
    # [3, H] partials by row: one per batch tile (unit tiles and clusters,
    # at the row of its first batch row) or one per row (W tiles)
    dpeep_part = torch.zeros((batch, 3, hidden), dtype=torch.float32,
                             device=dev)
    if plan is None:
        plan = bwd_plan(batch, hidden, gates_tm.dtype, *device_limits(dev))
    if plan["layout"] == "w_tiles":
        # z of every step (float32) and the column tiles' dh partials
        w_t = w_rec
        zbuf = torch.empty((steps, batch, g4), dtype=torch.float32,
                           device=dev)
        part = torch.empty((plan["col_tiles"], plan["rows_per_launch"],
                            hidden), dtype=torch.float32, device=dev)
        tiling = (plan["units"], plan["cols"], plan["rows_per_launch"],
                  int(plan["resident"]))
    elif plan["layout"] == "cluster":
        # z of every step (float32)
        w_t = w_rec
        zbuf = torch.empty((steps, batch, g4), dtype=torch.float32,
                           device=dev)
        part = torch.empty((0,), dtype=torch.float32, device=dev)
        tiling = (0, 0, plan["rows_per_block"], 0)
    else:
        # W transposed ([4H, H]) beside W: the unit-tile layout's dz . W^T
        # loop reads it coalesced
        w_t = w_rec.t().contiguous()
        zbuf = part = torch.empty((0,), dtype=torch.float32, device=dev)
        tiling = (0, 0, 0, 0)
    info = launch("lstm_seq_bwd", dev,
                  tuple(aligned(a) for a in args[:3] + (w_t,) + args[3:]),
                  (dgates, dh0, dc0, dpeep_part, zbuf, part),
                  (steps, batch, hidden, plan["code"]) + tiling,
                  _count_bwd_launches)
    lstm_seq_bwd.last_launch = dict(plan, **dict(zip(
        ("blocks", "rows_per_block", "w_placement", "smem_bytes",
         "grid_rows_per_launch", "launches"), info)))
    return (dgates, dh0, dc0, dpeep_part.sum(dim=0)), zbuf


lstm_seq_bwd.last_launch = None


class LstmSeq(torch.autograd.Function):
    """Differentiable whole-sequence LSTM: (gates_tm, mask_tm, w_rec, peep,
    h0, c0) -> (h_seq, h_f, c_f), as pallas_kernels.py ``lstm_fused``.
    Forward and backward are the kernel wrappers, on either device; mask_tm
    gets no gradient."""

    @staticmethod
    def forward(ctx, gates_tm, mask_tm, w_rec, peep, h0, c0):
        h_seq, c_seq = lstm_seq_fwd(gates_tm, mask_tm, w_rec, peep, h0, c0)
        ctx.save_for_backward(gates_tm, mask_tm, w_rec, peep, h0, c0, h_seq,
                              c_seq)
        return h_seq, h_seq[-1].clone(), c_seq[-1].clone()

    @staticmethod
    def backward(ctx, dh_seq, dh_f, dc_f):
        gates_tm, mask_tm, w_rec, peep, h0, c0, h_seq, c_seq = \
            ctx.saved_tensors
        hprev_tm = torch.cat([h0[None], h_seq[:-1]])
        cprev_tm = torch.cat([c0[None], c_seq[:-1]])
        dgates, dh0, dc0, dpeep = lstm_seq_bwd(
            gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
            dh_seq.contiguous(), dh_f.contiguous(), dc_f.contiguous())
        hidden = w_rec.shape[0]
        # the weight gradient: one large GEMM outside the kernel, as the JAX
        # VJP leaves it to XLA (pallas_kernels.py:640-643)
        dw = torch.matmul(hprev_tm.reshape(-1, hidden).t(),
                          dgates.reshape(-1, 4 * hidden))
        return dgates, None, dw, dpeep, dh0, dc0


lstm_seq = LstmSeq.apply
