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
lstm_seq_fwd.cu, one cooperative launch per sequence; a batch too large for
one co-resident grid runs as a few launches of equal row chunks, each
counted) or raises; on a CPU
tensor it runs ``lstm_seq_fwd_reference``, the plain loop of the same
function, which is also the oracle the kernel is held against.

``lstm_seq_bwd`` has the function and contract of the backward kernels K2
``_lstm_bwd_kernel`` and K4 ``_lstm_bwd_tiled_kernel`` (pallas_kernels.py
``_vjp_bwd``): from the saved forward (hprev = [h0, h_seq[:-1]], cprev =
[c0, c_seq[:-1]], c_seq) and the cotangents (dh_seq [T, B, H], dh_f, dc_f
[B, H]) it gives dgates [T, B, 4H] and dh0, dc0 [B, H] in the gates' dtype
and dpeep [3, H] in float32. Its kernel is csrc/lstm_seq_bwd.cu; on a CPU
tensor it runs ``lstm_seq_bwd_reference``.

``LstmSeq`` is the autograd Function around the pair (the JAX package's
``lstm_fused`` custom VJP): its forward is ``lstm_seq_fwd``, its backward
``lstm_seq_bwd`` plus the weight gradient hprev^T . dgates as one matmul
outside the kernel. It runs the same way on both devices, so the CPU tests
exercise the backward the card runs, not autograd through the plain loop.
"""

import threading

import torch

from paddle_tpu_torch.ops._build import check_args, launch
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


def lstm_seq_fwd(gates_tm, mask_tm, w_rec, peep, h0, c0):
    """Masked peephole-LSTM forward over the whole sequence (see module
    docstring). After a kernel call, ``lstm_seq_fwd.last_launch`` holds
    the grid the kernel chose and the number of launches it made."""
    _check(gates_tm, mask_tm, w_rec, peep, h0, c0)
    dev = gates_tm.device
    if dev.type == "cpu":
        return lstm_seq_fwd_reference(gates_tm, mask_tm, w_rec, peep, h0, c0)
    enforce(dev.type == "cuda", "lstm_seq_fwd runs on cuda or cpu tensors, "
            "got %s", dev)
    steps, batch, g4 = gates_tm.shape
    h_seq = torch.empty((steps, batch, g4 // 4), dtype=gates_tm.dtype,
                        device=dev)
    c_seq = torch.empty_like(h_seq)
    hbuf = torch.empty((2, batch, g4 // 4), dtype=gates_tm.dtype, device=dev)
    info = launch("lstm_seq_fwd", dev,
                   (gates_tm, mask_tm, w_rec, peep, h0, c0),
                   (h_seq, c_seq, hbuf), (steps, batch, g4 // 4),
                   _count_launches)
    lstm_seq_fwd.last_launch = dict(zip(
        ("blocks", "rows_per_block", "w_resident", "smem_bytes",
         "rows_per_launch", "launches"), info))
    return h_seq, c_seq


lstm_seq_fwd.last_launch = None


def lstm_seq_bwd(gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
                 dh_seq, dh_f, dc_f):
    """Masked peephole-LSTM backward over the whole sequence (see module
    docstring): -> dgates [T, B, 4H], dh0, dc0 [B, H], dpeep [3, H] f32.
    After a kernel call, ``lstm_seq_bwd.last_launch`` holds the grid the
    kernel chose and the number of launches it made."""
    args = (gates_tm, mask_tm, w_rec, peep, hprev_tm, cprev_tm, c_seq,
            dh_seq, dh_f, dc_f)
    _check_bwd(*args)
    dev = gates_tm.device
    if dev.type == "cpu":
        return lstm_seq_bwd_reference(*args)
    enforce(dev.type == "cuda", "lstm_seq_bwd runs on cuda or cpu tensors, "
            "got %s", dev)
    steps, batch, g4 = gates_tm.shape
    hidden = g4 // 4
    dgates = torch.empty_like(gates_tm)
    dh0 = torch.empty((batch, hidden), dtype=gates_tm.dtype, device=dev)
    dc0 = torch.empty_like(dh0)
    # one [3, H] partial per batch tile, at the row of its first batch row
    dpeep_part = torch.zeros((batch, 3, hidden), dtype=torch.float32,
                             device=dev)
    # W transposed ([4H, H]) beside W: the kernel's dz . W^T loop reads it
    # coalesced
    w_t = w_rec.t().contiguous()
    info = launch("lstm_seq_bwd", dev, args[:3] + (w_t,) + args[3:],
                   (dgates, dh0, dc0, dpeep_part), (steps, batch, hidden),
                   _count_bwd_launches)
    lstm_seq_bwd.last_launch = dict(zip(
        ("blocks", "rows_per_block", "w_placement", "smem_bytes",
         "rows_per_launch", "launches"), info))
    return dgates, dh0, dc0, dpeep_part.sum(dim=0)


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
