"""Whole-sequence GRU forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the autograd Function that joins them.

``gru_seq_fwd`` has the function and contract of paddle_tpu/ops/
pallas_kernels.py ``gru_fused`` forward (the TPU kernel K5
``_gru_fwd_kernel``):

    proj_tm [T, B, 3H]  x.W_in + b, gate columns u (update), r (reset),
                        c (candidate); float32 or bfloat16
    mask_tm [T, B]      float32; 0 = padded step, h copied forward
    w_rz    [H, 2H]     proj's dtype; columns [0:H] the update gate,
                        [H:2H] the reset gate
    w_c     [H, H]      proj's dtype
    h0      [B, H]      proj's dtype
    -> h_seq [T, B, H] in proj's dtype.

One step: u, r = sigmoid(proj_{u,r} + h.W_rz); c = tanh(proj_c +
round(r*h).W_c), with r*h rounded to proj's dtype; h = u*h + (1-u)*c,
stored in proj's dtype; every product sums in float32.

On a CUDA tensor the wrapper launches the kernel (paddle_tpu_torch/csrc/
gru_seq_fwd.cu) in one of two layouts that ``gru_fwd_plan`` picks from the
shapes and dtype: "cluster" (H % 8 == 0 up to 16 unit tiles, where all
the batch's clusters fit on the card at once: one thread-block cluster
per batch tile, each block's W_rz and W_c columns on chip, rh and h_t
exchanged through distributed shared memory behind two cluster barriers
a step) or "unit_tiles" (else: one cooperative launch per row chunk that
fits, two grid barriers a step; each launch counted), or raises; on a
CPU tensor it runs
``gru_seq_fwd_reference``, the plain loop of the same function, which is
also the oracle the kernel is held against.

``gru_seq_bwd`` has the function and contract of the backward kernel K6
``_gru_bwd_kernel`` (pallas_kernels.py ``_gru_vjp_bwd``): from the saved
forward (hprev = [h0, h_seq[:-1]]) and the cotangents (dh_seq [T, B, H],
dh_f [B, H]) it gives dproj [T, B, 3H] and dh0 [B, H] in proj's dtype; the
dh carry is float32. Its kernel is csrc/gru_seq_bwd.cu, in one of two
layouts that ``gru_bwd_plan`` picks from the shapes and dtype: "cluster"
(H % 8 == 0 up to 512 units: two recompute passes give u, r, rh and c for
all steps, then one thread-block cluster per batch tile, its blocks the
unit tiles, each step's dzc and [dzu, dzr] exchanged through distributed
shared memory behind two cluster barriers) or "unit_tiles" (what the
cluster layout does not take: the recompute inside the step loop, two
grid barriers a step); on a CPU tensor it runs ``gru_seq_bwd_reference``.

Launch counts: ``launches`` counts the forward kernel's launches and
``bwd_launches`` the backward's, since the last ``reset_launches()`` (a
launch made to compare a kernel with its plain version counts too; callers
reset around the path they read). They are this module's own, apart from
the LSTM kernels' counts.

``GruSeq`` is the autograd Function around the pair (the JAX package's
``gru_fused`` custom VJP): its forward is ``gru_seq_fwd``, its backward
``gru_seq_bwd`` plus the weight gradients as matmuls outside the kernel,
as the JAX VJP computes them: dw_rz = hprev^T . dproj_{u,r} and dw_c =
(r * hprev)^T . dproj_c with r recomputed in float32, unrounded. It runs
the same way on both devices, so the CPU tests exercise the backward the
card runs, not autograd through the plain loop.
"""

import threading

import torch

from paddle_tpu_torch.ops import clusters as cl
from paddle_tpu_torch.ops._build import aligned, check_args, launch
from paddle_tpu_torch.utils.error import enforce

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


def device_limits(dev):
    """(SM count, opt-in shared memory per block in bytes, (clusters of 8,
    clusters of 16)) of the card ``dev``, as the backward kernel's C side
    reads them for its cluster kernel (``clusters.device_limits``)."""
    return cl.device_limits("gru_seq_bwd", dev)


# The cluster layout (``clusters``): both W row slices resident, the
# exchange buffers and the warps' partial sums in float32. These constants
# and ``_cl_smem`` copy the kernel's (kXPad, cl_smem_bytes);
# tests/test_torch_gru_bwd_plan.py holds the two equal.
_CL_XPAD = 8


def _cl_xpad(hidden):
    """Floats of padding at the end of an exchange row: 8 in clusters of at
    most 8 blocks (where the bfloat16 path runs on the tensor cores), else
    none."""
    return _CL_XPAD if hidden <= 32 * cl.PORTABLE else 0


def _cl_smem(hidden, rows, esz):
    """Shared memory of a GRU cluster block (csrc/gru_seq_bwd.cu
    cl_smem_bytes): W_c's row slice [H][32] and W_rz's [H][32][2] in proj's
    dtype (rounded up to 16 bytes), then the exchange buffers [R][H + pad]
    and [R][2H + pad] (``_cl_xpad``) and the warps' partial
    sums [8][R][32] in float32."""
    return (-(-96 * hidden * esz // 16) * 16
            + 4 * rows * (3 * hidden + 2 * _cl_xpad(hidden)) + 1024 * rows)


def gru_bwd_plan(batch, hidden, dtype, smem=cl.H100_SMEM_OPTIN,
                 clusters=cl.H100_CLUSTERS):
    """The GRU backward's layout for a batch of ``batch`` rows at ``hidden``
    units in ``dtype`` on a card of ``smem`` bytes of shared memory per
    block and ``clusters`` (``device_limits``): "cluster" where it takes
    the shape (H % 8 == 0, at most 16 unit tiles, the row slices and
    buffers in ``smem``; ``rows_per_block`` by ``clusters.cluster_rows``),
    else "unit_tiles" (the kernel then picks its grid and W placement
    itself)."""
    enforce(dtype in (torch.float32, torch.bfloat16), "gru_seq_bwd takes "
            "float32 or bfloat16 inputs, got %s", dtype)
    esz = 4 if dtype == torch.float32 else 2
    rows = cl.cluster_rows(batch, hidden, lambda r: _cl_smem(hidden, r, esz),
                           smem, clusters)
    if rows is None:
        return {"layout": "unit_tiles", "code": 0}
    return {"layout": "cluster", "code": 2, "rows_per_block": rows,
            "cluster_size": -(-hidden // 32), "clusters": -(-batch // rows),
            "smem_bytes": _cl_smem(hidden, rows, esz)}


def fwd_device_limits(dev):
    """(SM count, opt-in shared memory per block in bytes, (clusters of 8,
    clusters of 16)) of the card ``dev``, as the forward kernel's C side
    reads them for its cluster kernel (``clusters.device_limits``)."""
    return cl.device_limits("gru_seq_fwd", dev)


def _fwd_cl_smem(hidden, rows, esz):
    """Shared memory of a GRU forward cluster block (csrc/gru_seq_fwd.cu
    cl_smem_bytes): W_rz's 64 and W_c's 32 columns where they are not in
    registers, h_{t-1} and rh of the block's rows, and the larger of the
    two products' scratch."""
    tiles = -(-hidden // 32)
    return (cl.fwd_w_bytes(tiles, 64, esz) + cl.fwd_w_bytes(tiles, 32, esz)
            + cl.fwd_state_bytes(tiles, rows, 2)
            + 4 * max(cl.fwd_scratch_floats(64, rows, esz),
                      cl.fwd_scratch_floats(32, rows, esz)))


def fwd_cluster_plan(batch, hidden, dtype, smem=cl.H100_SMEM_OPTIN,
                     clusters=cl.H100_CLUSTERS):
    """The GRU forward's cluster layout for this shape (H % 8 == 0, at most
    16 unit tiles, the block in ``smem``; ``rows_per_block`` by
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


def gru_fwd_plan(batch, hidden, dtype, smem=cl.H100_SMEM_OPTIN,
                 clusters=cl.H100_CLUSTERS):
    """The GRU forward's layout for a batch of ``batch`` rows at ``hidden``
    units in ``dtype`` on a card of ``smem`` bytes of shared memory per
    block and ``clusters`` (``fwd_device_limits``): "cluster"
    (``fwd_cluster_plan``) where its clusters all fit on the card at once,
    else "unit_tiles" (the kernel then picks its grid and W placement
    itself). A second wave of clusters doubles the step count the card
    runs, and then unit tiles are faster (H=512 at B=64: 13 clusters of 16
    blocks against the 7 an H100 holds)."""
    enforce(dtype in (torch.float32, torch.bfloat16), "gru_seq_fwd takes "
            "float32 or bfloat16 inputs, got %s", dtype)
    plan = fwd_cluster_plan(batch, hidden, dtype, smem, clusters)
    if plan is None or plan["clusters"] > cl.cluster_slots(hidden, clusters):
        return {"layout": "unit_tiles", "code": 0}
    return plan


def _gates(proj_t, h, w_rz, hidden):
    """u, r of one step in float32 from proj_t [B, 3H] and h (float32)."""
    rz = torch.matmul(h, w_rz)
    u = torch.sigmoid(proj_t[:, :hidden].float() + rz[:, :hidden])
    r = torch.sigmoid(proj_t[:, hidden:2 * hidden].float() + rz[:, hidden:])
    return u, r


def gru_seq_fwd_reference(proj_tm, mask_tm, w_rz, w_c, h0):
    """The plain PyTorch loop of the kernel's function (same dtype rules as
    pallas_kernels.py ``_gru_fwd_kernel``: f32 products and sums, r*h and
    h rounded to proj's dtype at every step)."""
    steps, _, g3 = proj_tm.shape
    hidden = g3 // 3
    dt = proj_tm.dtype
    w_rz, w_c = w_rz.float(), w_c.float()
    h = h0.to(dt)
    hs = []
    for t in range(steps):
        hp = h.float()
        u, r = _gates(proj_tm[t], hp, w_rz, hidden)
        rh = (r * hp).to(dt).float()
        c = torch.tanh(proj_tm[t, :, 2 * hidden:].float()
                       + torch.matmul(rh, w_c))
        h_new = u * hp + (1.0 - u) * c
        h = torch.where((mask_tm[t] > 0)[:, None], h_new.to(dt), h)
        hs.append(h)
    return torch.stack(hs)


def gru_seq_bwd_reference(proj_tm, mask_tm, w_rz, w_c, hprev_tm, dh_seq,
                          dh_f):
    """The plain PyTorch reverse loop of the backward kernel's function
    (same dtype rules as pallas_kernels.py ``_gru_bwd_kernel``: u, r, c
    recomputed in f32 with r*h rounded to proj's dtype; the dh carry in
    f32; dzc rounded to w_c's dtype before dzc . W_c^T and [dzu, dzr] to
    w_rz's before . W_rz^T; dproj and dh0 in proj's dtype)."""
    steps, _, g3 = proj_tm.shape
    hidden = g3 // 3
    dt = proj_tm.dtype
    wrz, wc = w_rz.float(), w_c.float()
    dh = dh_f.float()
    dproj = torch.empty_like(proj_tm)
    for t in range(steps - 1, -1, -1):
        h32 = hprev_tm[t].float()
        u, r = _gates(proj_tm[t], h32, wrz, hidden)
        rh = (r * h32).to(dt).float()
        c = torch.tanh(proj_tm[t, :, 2 * hidden:].float()
                       + torch.matmul(rh, wc))
        m = (mask_tm[t] > 0)[:, None]
        dh_tot = dh_seq[t].float() + dh
        dh_eff = torch.where(m, dh_tot, 0.0)
        du = dh_eff * (h32 - c)
        dzc = dh_eff * (1.0 - u) * (1.0 - c * c)
        drh = torch.matmul(dzc.to(w_c.dtype).float(), wc.t())
        dzu = du * u * (1.0 - u)
        dzr = drh * h32 * r * (1.0 - r)
        dzrz = torch.cat([dzu, dzr], dim=-1)
        dh = (dh_eff * u + drh * r
              + torch.matmul(dzrz.to(w_rz.dtype).float(), wrz.t())
              + torch.where(m, 0.0, dh_tot))
        dproj[t] = torch.cat([dzu, dzr, dzc], dim=-1).to(dt)
    return dproj, dh.to(dt)


def _proj_shape(proj_tm):
    """(T, B, H) of proj [T, B, 3H]."""
    enforce(proj_tm.dim() == 3 and proj_tm.shape[-1] % 3 == 0,
            "proj_tm must be [T, B, 3H], got %s", tuple(proj_tm.shape))
    steps, batch, g3 = proj_tm.shape
    return steps, batch, g3 // 3


def _weights(proj_tm, mask_tm, w_rz, w_c):
    steps, batch, hidden = _proj_shape(proj_tm)
    return (steps, batch, hidden), (
        ("mask_tm", mask_tm, (steps, batch), torch.float32),
        ("w_rz", w_rz, (hidden, 2 * hidden), None),
        ("w_c", w_c, (hidden, hidden), None))


def _check(proj_tm, mask_tm, w_rz, w_c, h0):
    (steps, batch, hidden), named = _weights(proj_tm, mask_tm, w_rz, w_c)
    check_args("gru_seq_fwd", proj_tm,
               named + (("h0", h0, (batch, hidden), None),))


def _check_bwd(proj_tm, mask_tm, w_rz, w_c, hprev_tm, dh_seq, dh_f):
    (steps, batch, hidden), named = _weights(proj_tm, mask_tm, w_rz, w_c)
    seq = (steps, batch, hidden)
    check_args("gru_seq_bwd", proj_tm, named + (
        ("hprev_tm", hprev_tm, seq, None),
        ("dh_seq", dh_seq, seq, None),
        ("dh_f", dh_f, (batch, hidden), None)))


def gru_seq_fwd(proj_tm, mask_tm, w_rz, w_c, h0, plan=None):
    """Masked GRU forward over the whole sequence (see module docstring).
    With ``plan=None`` the call goes through the registered op
    ``torch.ops.paddle_tpu_torch.gru_seq_fwd`` (``gru_seq_fwd_op``), which
    launches the kernel in ``gru_fwd_plan``'s layout for this card on a
    CUDA tensor and runs the plain version on a CPU tensor; an exported
    program records that op. ``plan`` (a ``gru_fwd_plan`` result) launches
    that layout directly instead. After a kernel call,
    ``gru_seq_fwd.last_launch`` holds the plan, the grid the kernel chose
    and the number of launches it made."""
    args = (proj_tm, mask_tm, w_rz, w_c, h0)
    _check(*args)
    if plan is None:
        return gru_seq_fwd_op(*args)
    if proj_tm.device.type == "cpu":
        return gru_seq_fwd_reference(*args)
    return _launch_fwd(args, plan)


def _launch_fwd(args, plan):
    """One call of the forward kernel on checked inputs ``args`` (a CUDA
    tensor, else raises) in layout ``plan`` (None: ``gru_fwd_plan``'s)."""
    proj_tm = args[0]
    dev = proj_tm.device
    enforce(dev.type == "cuda", "gru_seq_fwd runs on cuda or cpu tensors, "
            "got %s", dev)
    steps, batch, hidden = _proj_shape(proj_tm)
    if plan is None:
        _, smem, clusters = fwd_device_limits(dev)
        plan = gru_fwd_plan(batch, hidden, proj_tm.dtype, smem, clusters)
    h_seq = torch.empty((steps, batch, hidden), dtype=proj_tm.dtype,
                        device=dev)
    # the unit tiles' rh scratch rows (the clusters keep rh on chip)
    rh = torch.empty((batch, hidden) if plan["layout"] == "unit_tiles"
                     else (0,), dtype=proj_tm.dtype, device=dev)
    info = launch("gru_seq_fwd", dev, tuple(aligned(a) for a in args),
                  (h_seq, rh),
                  (steps, batch, hidden, plan["code"],
                   plan.get("rows_per_block", 0)),
                  _count_launches)
    gru_seq_fwd.last_launch = dict(plan, **dict(zip(
        ("blocks", "rows_per_block", "w_placement", "smem_bytes",
         "rows_per_launch", "launches"), info)))
    return h_seq


@torch.library.custom_op("paddle_tpu_torch::gru_seq_fwd", mutates_args=(),
                         device_types="cpu")
def gru_seq_fwd_op(proj_tm: torch.Tensor, mask_tm: torch.Tensor,
                   w_rz: torch.Tensor, w_c: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """The forward as a registered op (K5): the plain version on the CPU,
    the kernel on the card (``_launch_fwd``, which counts the launches),
    the output shape alone while a program is traced."""
    return gru_seq_fwd_reference(proj_tm, mask_tm, w_rz, w_c, h0)


@gru_seq_fwd_op.register_kernel("cuda")
def _gru_seq_fwd_cuda(proj_tm, mask_tm, w_rz, w_c, h0):
    return _launch_fwd((proj_tm, mask_tm, w_rz, w_c, h0), None)


@gru_seq_fwd_op.register_fake
def _gru_seq_fwd_fake(proj_tm, mask_tm, w_rz, w_c, h0):
    steps, batch, hidden = _proj_shape(proj_tm)
    return proj_tm.new_empty((steps, batch, hidden))


gru_seq_fwd.last_launch = None


def gru_seq_bwd(proj_tm, mask_tm, w_rz, w_c, hprev_tm, dh_seq, dh_f,
                plan=None):
    """Masked GRU backward over the whole sequence (see module docstring):
    -> dproj [T, B, 3H], dh0 [B, H]. On a CUDA tensor ``plan`` is the
    layout to run (a ``gru_bwd_plan`` result; None: ``gru_bwd_plan``'s
    choice for this card). After a kernel call, ``gru_seq_bwd.last_launch``
    holds the plan, the grid the kernel chose and the number of launches it
    made."""
    args = (proj_tm, mask_tm, w_rz, w_c, hprev_tm, dh_seq, dh_f)
    _check_bwd(*args)
    dev = proj_tm.device
    if dev.type == "cpu":
        return gru_seq_bwd_reference(*args)
    enforce(dev.type == "cuda", "gru_seq_bwd runs on cuda or cpu tensors, "
            "got %s", dev)
    return _launch_bwd(args, plan)[0]


def _launch_bwd(args, plan):
    """One call of the backward kernel on checked CUDA inputs ``args``:
    ((dproj, dh0), (zbuf, rh)), the workspaces as the call leaves them
    (clusters: u, r, c [T, B, 3H] in float32 and rh [T, B, H] of every
    step, as the recompute passes wrote them)."""
    proj_tm, _, w_rz, w_c = args[:4]
    dev = proj_tm.device
    steps, batch, hidden = _proj_shape(proj_tm)
    dproj = torch.empty_like(proj_tm)
    dh0 = torch.empty((batch, hidden), dtype=proj_tm.dtype, device=dev)
    if plan is None:
        _, smem, clusters = device_limits(dev)
        plan = gru_bwd_plan(batch, hidden, proj_tm.dtype, smem, clusters)
    if plan["layout"] == "cluster":
        # u, r, c of every step (float32) and rh of every step
        w_t = (w_rz, w_c)
        rh = torch.empty((steps, batch, hidden), dtype=proj_tm.dtype,
                         device=dev)
        zbuf = torch.empty((steps, batch, 3 * hidden), dtype=torch.float32,
                           device=dev)
        rows = plan["rows_per_block"]
    else:
        # W_rz and W_c transposed beside them: the kernel's dzc . W_c^T and
        # [dzu, dzr] . W_rz^T loops read them coalesced
        w_t = (w_rz.t().contiguous(), w_c.t().contiguous())
        rh = torch.empty_like(dh0)
        zbuf = torch.empty((0,), dtype=torch.float32, device=dev)
        rows = 0
    info = launch("gru_seq_bwd", dev,
                  tuple(aligned(a) for a in args[:4] + w_t + args[4:]),
                  (dproj, dh0, rh, zbuf),
                  (steps, batch, hidden, plan["code"], rows),
                  _count_bwd_launches)
    gru_seq_bwd.last_launch = dict(plan, **dict(zip(
        ("blocks", "rows_per_block", "w_placement", "smem_bytes",
         "rows_per_launch", "launches"), info)))
    return (dproj, dh0), (zbuf, rh)


gru_seq_bwd.last_launch = None


def _weight_grads(proj_tm, w_rz, hprev_tm, dproj):
    """dw_rz = hprev^T . dproj_{u,r} and dw_c = (r * hprev)^T . dproj_c,
    each one matmul over all T*B rows in float32, r recomputed in float32
    and unrounded (pallas_kernels.py:827-839); cast to the weights'
    dtype."""
    hidden = w_rz.shape[0]
    hp = hprev_tm.reshape(-1, hidden).float()
    dp = dproj.reshape(-1, 3 * hidden).float()
    dw_rz = torch.matmul(hp.t(), dp[:, :2 * hidden])
    zr = torch.matmul(hp, w_rz[:, hidden:].float())
    r = torch.sigmoid(proj_tm[..., hidden:2 * hidden].reshape(-1, hidden)
                      .float() + zr)
    dw_c = torch.matmul((r * hp).t(), dp[:, 2 * hidden:])
    return dw_rz.to(w_rz.dtype), dw_c.to(w_rz.dtype)


class GruSeq(torch.autograd.Function):
    """Differentiable whole-sequence GRU: (proj_tm, mask_tm, w_rz, w_c, h0)
    -> (h_seq, h_f), as pallas_kernels.py ``gru_fused``. Forward and
    backward are the kernel wrappers, on either device; mask_tm gets no
    gradient."""

    @staticmethod
    def forward(ctx, proj_tm, mask_tm, w_rz, w_c, h0):
        h_seq = gru_seq_fwd(proj_tm, mask_tm, w_rz, w_c, h0)
        ctx.save_for_backward(proj_tm, mask_tm, w_rz, w_c, h0, h_seq)
        return h_seq, h_seq[-1].clone()

    @staticmethod
    def backward(ctx, dh_seq, dh_f):
        proj_tm, mask_tm, w_rz, w_c, h0, h_seq = ctx.saved_tensors
        hprev_tm = torch.cat([h0[None], h_seq[:-1]])
        dproj, dh0 = gru_seq_bwd(proj_tm, mask_tm, w_rz, w_c, hprev_tm,
                                 dh_seq.contiguous(), dh_f.contiguous())
        dw_rz, dw_c = _weight_grads(proj_tm, w_rz, hprev_tm, dproj)
        return dproj, None, dw_rz, dw_c, dh0


gru_seq = GruSeq.apply
