"""Recurrent ops: the LSTM, GRU and vanilla RNN steps and their masked
sequence scans (paddle_tpu/ops/rnn.py).

The [B*T, D] x [D, 4H] (or 3H) input projection runs outside the scan as
one matmul; the scan carries only the recurrent state. Masking freezes
state past each sequence's end. LSTM gate layout is [input, forget, cell
(candidate), output] on the last axis; GRU layout is [update, reset,
candidate].

``reverse=True`` runs each sequence right to left within its valid
region: the input is reversed before the scan and the output reversed
back (``SequenceBatch.reverse``; paddle_tpu/ops/rnn.py:140-146, 193-197),
so the padding stays at the end of every row and the kernels' masks mean
what they mean in a forward scan.
"""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops.gru_kernels import gru_seq
from paddle_tpu_torch.ops.lstm_kernels import lstm_seq


def lstm_step(carry, gates_t, w_rec, mask_t, gate_act, state_act,
              use_peephole=False, w_peep=None, out_act=None):
    """One LSTM step. carry=(h, c); gates_t [B, 4H] is the precomputed
    input projection (+bias); w_rec [H, 4H]. i,f = gate_act, candidate g
    via ``state_act``, cell output via ``out_act`` (tanh by default)."""
    h_prev, c_prev = carry
    z = gates_t + torch.matmul(h_prev, w_rec)
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    if use_peephole:
        pi, pf, po = torch.chunk(w_peep, 3, dim=-1)
        zi = zi + c_prev * pi
        zf = zf + c_prev * pf
    i = gate_act(zi)
    f = gate_act(zf)
    g = state_act(zg)
    c = f * c_prev + i * g
    if use_peephole:
        zo = zo + c * po
    o = gate_act(zo)
    h = o * (out_act or state_act)(c)
    m = mask_t[:, None] > 0
    # the carry keeps its dtype, as the JAX step does
    h = torch.where(m, h, h_prev).to(h_prev.dtype)
    c = torch.where(m, c, c_prev).to(c_prev.dtype)
    return (h, c), h


def gru_step(carry, inp_t, w_rec_rz, w_rec_c, mask_t, gate_act, state_act):
    """One GRU step, reference gate order (hl_gpu_gru.cuh): update u,
    reset r, candidate c. inp_t [B, 3H] is the precomputed input
    projection; the update gate keeps the old state."""
    h_prev = carry
    xu, xr, xc = torch.chunk(inp_t, 3, dim=-1)
    zu_r, zr_r = torch.chunk(torch.matmul(h_prev, w_rec_rz), 2, dim=-1)
    u = gate_act(xu + zu_r)
    r = gate_act(xr + zr_r)
    c = state_act(xc + torch.matmul(r * h_prev, w_rec_c))
    h = u * h_prev + (1.0 - u) * c
    h = torch.where(mask_t[:, None] > 0, h, h_prev)
    return h, h


def rnn_step(carry, inp_t, w_rec, mask_t, act):
    """One vanilla RNN step: h = act(inp_t + h_prev @ w_rec), the carry
    kept where the step is masked."""
    h = act(inp_t + torch.matmul(carry, w_rec))
    h = torch.where(mask_t[:, None] > 0, h, carry)
    return h, h


def _reversed(x_btd, mask_bt):
    """x reversed within the valid region of each row of ``mask_bt``."""
    lengths = (mask_bt > 0).sum(dim=1)
    return SequenceBatch(x_btd, lengths).reverse().data


def _check_reset(reset_bt, reverse):
    """A packed reset mask composes with reverse only when the caller
    pre-reverses per segment (``PackedSequenceBatch.reverse``): the
    scans' whole-row reverse would mix packed neighbours
    (paddle_tpu/ops/rnn.py ``_check_reset``)."""
    if reset_bt is not None and reverse:
        raise ValueError(
            "reset_bt (packed sequences) cannot combine with reverse=True "
            "inside the scan; pre-reverse per segment with "
            "PackedSequenceBatch.reverse() and scan forward")


def _reset_carry(carry, boot, r_t):
    """The carry where ``r_t`` [B] is 0, the boot state where it is 1."""
    return carry * (1.0 - r_t)[:, None] + boot * r_t[:, None]


def lstm_scan(x_btd, mask_bt, w_in, b, w_rec, h0=None, c0=None,
              gate_act=torch.sigmoid, state_act=torch.tanh, reverse=False,
              use_peephole=False, w_peep=None, standard_acts=None,
              out_act=None, reset_bt=None):
    """Full-sequence LSTM. x [B, T, D] -> h_seq [B, T, H], (h_T, c_T).

    With standard activations (sigmoid gates, tanh states) the whole scan
    is one ``lstm_kernels.lstm_seq`` call, the autograd Function whose
    forward and backward are the hand-written kernels on a CUDA tensor and
    their plain versions on a CPU tensor — the eligibility of paddle_tpu/
    ops/rnn.py:149-165 without the TPU's VMEM test; gradients reach gates,
    w_rec, the peepholes, h0 and c0 only through it. Other activations take
    the eager ``lstm_step`` loop on either device, differentiated by
    autograd (the JAX package's own non-kernel branch, rnn.py:167-191).
    ``reverse`` reverses around the scan (module docstring).

    ``reset_bt`` [B, T] (packed sequences, ``PackedSequenceBatch.
    reset_mask``): where it is 1 the carry returns to (h0, c0) before the
    cell computes, so packed neighbours never see each other's state.
    The JAX package takes ``lax.scan`` there and no Pallas kernel
    (rnn.py:160), so a reset scan is the eager step loop on either
    device.
    """
    _check_reset(reset_bt, reverse)
    b_, t, d = x_btd.shape
    hidden = w_rec.shape[0]
    if w_in is None:  # input already projected to 4H (lstmemory contract)
        gates = x_btd
    else:
        gates = torch.matmul(x_btd.reshape(b_ * t, d),
                             w_in).reshape(b_, t, 4 * hidden)
    if b is not None:
        gates = gates + b
    if h0 is None:
        h0 = torch.zeros((b_, hidden), dtype=x_btd.dtype, device=x_btd.device)
    if c0 is None:
        c0 = torch.zeros((b_, hidden), dtype=x_btd.dtype, device=x_btd.device)
    if reverse:
        gates = _reversed(gates, mask_bt)
    gates_tm = gates.transpose(0, 1).contiguous()
    mask_tm = mask_bt.transpose(0, 1)

    if standard_acts is None:
        standard_acts = (gate_act is torch.sigmoid and state_act is torch.tanh
                         and out_act in (None, torch.tanh))
    if (reset_bt is None and standard_acts
            and gates_tm.dtype in (torch.float32, torch.bfloat16)):
        if use_peephole:
            peep = w_peep.reshape(3, hidden).float()
        else:
            peep = torch.zeros((3, hidden), dtype=torch.float32,
                               device=gates_tm.device)
        ys, h_f, c_f = lstm_seq(
            gates_tm, mask_tm.float().contiguous(), w_rec.contiguous(),
            peep.contiguous(), h0.contiguous(), c0.contiguous())
    else:
        carry = (h0, c0)
        outs = []
        reset_tm = (None if reset_bt is None
                    else reset_bt.transpose(0, 1).to(gates_tm.dtype))
        for step in range(t):
            if reset_tm is not None:
                carry = (_reset_carry(carry[0], h0, reset_tm[step]),
                         _reset_carry(carry[1], c0, reset_tm[step]))
            carry, y = lstm_step(carry, gates_tm[step], w_rec, mask_tm[step],
                                 gate_act, state_act,
                                 use_peephole=use_peephole, w_peep=w_peep,
                                 out_act=out_act)
            outs.append(y)
        h_f, c_f = carry
        ys = torch.stack(outs)
    h_seq = ys.transpose(0, 1)
    if reverse:
        h_seq = _reversed(h_seq, mask_bt)
    return h_seq * mask_bt[..., None].to(h_seq.dtype), (h_f, c_f)


def gru_scan(x_btd, mask_bt, w_in, b, w_rec_rz, w_rec_c, h0=None,
             gate_act=torch.sigmoid, state_act=torch.tanh, reverse=False,
             reset_bt=None, standard_acts=None):
    """Full-sequence GRU. x [B, T, D] -> h_seq [B, T, H], h_T.

    With standard activations (sigmoid gates, tanh candidate) and float32
    or bfloat16 inputs the whole scan is one ``gru_kernels.gru_seq`` call,
    the autograd Function whose forward and backward are the hand-written
    kernels on a CUDA tensor and their plain versions on a CPU tensor (the
    eligibility of paddle_tpu/ops/rnn.py:228-234 without the TPU's VMEM
    test). Other activations take the eager ``gru_step`` loop on either
    device, differentiated by autograd (rnn.py:235-241). ``reverse``
    reverses around the scan (module docstring). ``reset_bt`` returns the
    carry to h0 at packed-segment starts, on the step loop (see
    ``lstm_scan``).
    """
    _check_reset(reset_bt, reverse)
    b_, t, d = x_btd.shape
    hidden = w_rec_c.shape[0]
    if w_in is None:  # input already projected to 3H (grumemory contract)
        proj = x_btd
    else:
        proj = torch.matmul(x_btd.reshape(b_ * t, d),
                            w_in).reshape(b_, t, 3 * hidden)
    if b is not None:
        proj = proj + b
    if h0 is None:
        h0 = torch.zeros((b_, hidden), dtype=x_btd.dtype, device=x_btd.device)
    if reverse:
        proj = _reversed(proj, mask_bt)
    proj_tm = proj.transpose(0, 1).contiguous()
    mask_tm = mask_bt.transpose(0, 1)

    if standard_acts is None:
        standard_acts = gate_act is torch.sigmoid and state_act is torch.tanh
    if (reset_bt is None and standard_acts
            and proj_tm.dtype in (torch.float32, torch.bfloat16)):
        ys, h_f = gru_seq(proj_tm, mask_tm.float().contiguous(),
                          w_rec_rz.contiguous(), w_rec_c.contiguous(),
                          h0.contiguous())
    else:
        h_f = h0
        outs = []
        reset_tm = (None if reset_bt is None
                    else reset_bt.transpose(0, 1).to(proj_tm.dtype))
        for step in range(t):
            if reset_tm is not None:
                h_f = _reset_carry(h_f, h0, reset_tm[step])
            h_f, y = gru_step(h_f, proj_tm[step], w_rec_rz, w_rec_c,
                              mask_tm[step], gate_act, state_act)
            outs.append(y)
        ys = torch.stack(outs)
    h_seq = ys.transpose(0, 1)
    if reverse:
        h_seq = _reversed(h_seq, mask_bt)
    return h_seq * mask_bt[..., None].to(h_seq.dtype), h_f


def rnn_scan(x_btd, mask_bt, w_rec, h0=None, act=torch.tanh, reverse=False,
             reset_bt=None):
    """Vanilla RNN over a precomputed input projection x [B, T, H]
    (reference: RecurrentLayer; paddle_tpu/ops/rnn.py:261) -> h_seq
    [B, T, H], h_T. The JAX package runs it on ``lax.scan`` with no Pallas
    kernel, so this is a step loop on either device, differentiated by
    autograd. ``reverse`` reverses around the scan (module docstring);
    ``reset_bt`` returns the carry to h0 at packed-segment starts (see
    ``lstm_scan``)."""
    _check_reset(reset_bt, reverse)
    b_, t, hidden = x_btd.shape
    if h0 is None:
        h0 = torch.zeros((b_, hidden), dtype=x_btd.dtype, device=x_btd.device)
    inp = _reversed(x_btd, mask_bt) if reverse else x_btd
    inp_tm = inp.transpose(0, 1)
    mask_tm = mask_bt.transpose(0, 1)
    reset_tm = (None if reset_bt is None
                else reset_bt.transpose(0, 1).to(inp_tm.dtype))
    h_f, outs = h0, []
    for step in range(t):
        if reset_tm is not None:
            h_f = _reset_carry(h_f, h0, reset_tm[step])
        h_f, y = rnn_step(h_f, inp_tm[step], w_rec, mask_tm[step], act)
        outs.append(y)
    h_seq = (torch.stack(outs) if outs else inp_tm).transpose(0, 1)
    if reverse:
        h_seq = _reversed(h_seq, mask_bt)
    return h_seq * mask_bt[..., None].to(h_seq.dtype), h_f
