"""The port's whole-sequence GRU against the JAX package, on the CPU.

- ``gru_seq_fwd_reference`` / ``gru_seq_bwd_reference`` (the plain versions
  of csrc/gru_seq_fwd.cu and csrc/gru_seq_bwd.cu) against the Pallas
  kernels K5 ``_gru_fwd`` and K6 ``_gru_bwd`` in interpret mode, as
  tests/test_pallas_kernels.py runs them, in float32 and bfloat16.
- ``GruSeq`` (forward, backward and the weight gradients outside the
  kernel) against ``jax.grad`` of ``pk.gru_fused``, and the port's
  ``rnn.gru_scan`` against the JAX ``gru_scan`` on its lax.scan branch;
  a stub proves the CPU backward goes through ``gru_seq_bwd_reference``.
- The gate column order (update, then reset) with independently drawn
  weights, the non-standard-activation branch, and what is not ported.

Inputs come from a numpy seed: B=4, T=6, H=64, lengths [6, 3, 5, 1] (the
JAX kernel tests' shapes), h0 and dh_f nonzero. Tolerances, float32: both
sides sum the same products in another order (XLA's dot against
torch.matmul on the CPU), compounding over the T steps; 1e-5 relative to
each tensor's largest |entry| is about thirty times the largest
difference these inputs show (3.5e-7). bfloat16: the two sides round r*h,
h and dz to bfloat16 at the same places, and on these inputs they agree
bit for bit but for dw_c (3e-8, a float32 sum in another order); a sum
taken in another order could still land on the other side of a rounding
boundary, so the limit is one bfloat16 step (2^-8) of the largest entry.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.ops import rnn as torch_rnn
from paddle_tpu_torch.utils.error import EnforceError

B, T, H = 4, 6, 64
LENGTHS = np.array([6, 3, 5, 1])
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


@pytest.fixture
def interpret(monkeypatch):
    if not pk.available():
        pytest.skip("pallas unavailable in this JAX install")
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _inputs(seed, hidden=H):
    """Time-major GRU inputs; the update and reset columns of w_rz are
    drawn independently (a swap of the two shows)."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    return {
        "proj": (rng.randn(T, B, 3 * hidden) * 0.5).astype(np.float32),
        "mask": mask,
        "w_rz": (rng.randn(hidden, 2 * hidden) / np.sqrt(hidden)).astype(
            np.float32),
        "w_c": (rng.randn(hidden, hidden) / np.sqrt(hidden)).astype(
            np.float32),
        "h0": (rng.randn(B, hidden) * 0.5).astype(np.float32),
        # cotangents of h_seq [T, B, H] and h_f
        "r_seq": rng.randn(T, B, hidden).astype(np.float32),
        "r_h": rng.randn(B, hidden).astype(np.float32),
    }


_FWD = ("proj", "mask", "w_rz", "w_c", "h0")
_WRT = ("proj", "w_rz", "w_c", "h0")


def _close(got, want, dtype_name, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert got.shape == want.shape, what
    assert err <= TOL[dtype_name], "%s: max |err| / max |want| = %g" % (
        what, err)


def _jax_arrays(x, dtype):
    return [jnp.asarray(x[k], jnp.float32 if k == "mask" else dtype)
            for k in _FWD]


def _torch_arrays(x, dtype):
    return [torch.from_numpy(x[k]).to(torch.float32 if k == "mask"
                                      else dtype) for k in _FWD]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_forward_and_backward_match_jax_kernels(dtype_name, interpret):
    """The plain versions against K5 ``_gru_fwd`` and K6 ``_gru_bwd``
    (interpret mode) on the same inputs."""
    x = _inputs(seed=1)
    jdt, tdt = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    want_h = pk._gru_fwd(*_jax_arrays(x, jdt))
    got_h = gk.gru_seq_fwd_reference(*_torch_arrays(x, tdt))
    assert got_h.dtype == tdt
    _close(got_h.float(), want_h, dtype_name, "h_seq")
    # the backward from the same saved forward (the JAX one's h_seq)
    h_seq = np.asarray(want_h.astype(jnp.float32))
    hprev = np.concatenate([x["h0"][None], h_seq[:-1]])
    rng = np.random.RandomState(2)
    dh_seq = rng.randn(T, B, H).astype(np.float32)
    dh_f = rng.randn(B, H).astype(np.float32)
    want = pk._gru_bwd(*_jax_arrays(x, jdt)[:4],
                       *(jnp.asarray(a, jdt) for a in (hprev, dh_seq, dh_f)))
    got = gk.gru_seq_bwd_reference(
        *_torch_arrays(x, tdt)[:4],
        *(torch.from_numpy(a).to(tdt) for a in (hprev, dh_seq, dh_f)))
    for name, g, w in zip(("dproj", "dh0"), got, want):
        assert g.dtype == tdt
        _close(g.float(), w.astype(jnp.float32), dtype_name, name)


def _jax_fused_grads(x, dtype):
    def loss(proj, w_rz, w_c, h0):
        h_seq, h_f = pk.gru_fused(proj, jnp.asarray(x["mask"]), w_rz, w_c,
                                  h0)
        return (jnp.sum(h_seq.astype(jnp.float32) * x["r_seq"])
                + jnp.sum(h_f.astype(jnp.float32) * x["r_h"]))

    args = [jnp.asarray(x[k], dtype) for k in _WRT]
    h_seq, h_f = pk.gru_fused(args[0], jnp.asarray(x["mask"]), *args[1:])
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a.astype(jnp.float32))
            for a in (h_seq, h_f) + tuple(grads)]


def _gru_seq_grads(x, dtype):
    leaves = {k: torch.from_numpy(x[k]).to(dtype).requires_grad_()
              for k in _WRT}
    h_seq, h_f = gk.gru_seq(leaves["proj"], torch.from_numpy(x["mask"]),
                            leaves["w_rz"], leaves["w_c"], leaves["h0"])
    loss = ((h_seq.float() * torch.from_numpy(x["r_seq"])).sum()
            + (h_f.float() * torch.from_numpy(x["r_h"])).sum())
    loss.backward()
    return [a.detach().float().numpy() for a in (h_seq, h_f)] + [
        leaves[k].grad.float().numpy() for k in _WRT]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gru_seq_forward_and_grads_match_jax_gru_fused(dtype_name, interpret,
                                                       monkeypatch):
    """GruSeq against jax.grad of pk.gru_fused (Pallas, interpret): h_seq,
    h_f, dproj, dw_rz, dw_c, dh0; the plain backward ran once."""
    calls = []
    plain = gk.gru_seq_bwd_reference
    monkeypatch.setattr(gk, "gru_seq_bwd_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    x = _inputs(seed=3)
    got = _gru_seq_grads(x, getattr(torch, dtype_name))
    want = _jax_fused_grads(x, jnp.dtype(dtype_name))
    assert calls == [(T, B, 3 * H)]
    for name, g, w in zip(("h_seq", "h_f", "dproj", "dw_rz", "dw_c", "dh0"),
                          got, want):
        _close(g, w, dtype_name, name)


def _scan_inputs(seed):
    """Batch-major inputs for the scans: x [B, T, 3H] (already projected),
    mask [B, T], and the cotangents of h_seq [B, T, H] and h_f."""
    x = _inputs(seed)
    return dict(x, proj=x["proj"].transpose(1, 0, 2).copy(),
                mask=x["mask"].T.copy(),
                r_seq=x["r_seq"].transpose(1, 0, 2).copy())


def _jax_scan_grads(x, gate_act=jax.nn.sigmoid, state_act=jnp.tanh):
    def run(proj, w_rz, w_c, h0):
        return jax_rnn.gru_scan(proj, jnp.asarray(x["mask"]), None, None,
                                w_rz, w_c, h0=h0, gate_act=gate_act,
                                state_act=state_act)

    def loss(*args):
        h_seq, h_f = run(*args)
        return jnp.sum(h_seq * x["r_seq"]) + jnp.sum(h_f * x["r_h"])

    args = [jnp.asarray(x[k]) for k in _WRT]
    h_seq, h_f = run(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a) for a in (h_seq, h_f) + tuple(grads)]


def _torch_scan_grads(x, gate_act=torch.sigmoid, state_act=torch.tanh):
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in _WRT}
    h_seq, h_f = torch_rnn.gru_scan(
        leaves["proj"], torch.from_numpy(x["mask"]), None, None,
        leaves["w_rz"], leaves["w_c"], h0=leaves["h0"], gate_act=gate_act,
        state_act=state_act)
    loss = ((h_seq * torch.from_numpy(x["r_seq"])).sum()
            + (h_f * torch.from_numpy(x["r_h"])).sum())
    loss.backward()
    return [a.detach().numpy() for a in (h_seq, h_f)] + [
        leaves[k].grad.numpy() for k in _WRT]


def test_gru_scan_matches_jax_lax_scan_branch(monkeypatch):
    """The port's gru_scan (kernel branch: GruSeq on its plain versions)
    against the JAX gru_scan on its lax.scan branch (the fused path is
    off: no interpret flag on the CPU), forward and gradients, float32."""
    assert not pk.enabled()
    calls = []
    plain = gk.gru_seq_bwd_reference
    monkeypatch.setattr(gk, "gru_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    x = _scan_inputs(seed=4)
    got = _torch_scan_grads(x)
    assert calls == [1]
    for name, g, w in zip(("h_seq", "h_f", "dproj", "dw_rz", "dw_c", "dh0"),
                          got, _jax_scan_grads(x)):
        _close(g, w, "float32", name)
    # padded steps of h_seq are zero, as in the JAX scan
    assert not got[0][3, 1:].any()


def test_non_standard_activations_take_the_step_loop_like_jax(monkeypatch):
    """tanh gates and a sigmoid candidate: not the kernel's function, so
    both packages run their step loop (JAX gru_step under lax.scan, the
    port's gru_step under autograd); the GRU kernels' plain versions are
    never called."""
    x = _scan_inputs(seed=5)

    def forbidden(*args):
        raise AssertionError("the kernel path ran for non-standard acts")

    monkeypatch.setattr(gk, "gru_seq_fwd_reference", forbidden)
    monkeypatch.setattr(gk, "gru_seq_bwd_reference", forbidden)
    got = _torch_scan_grads(x, gate_act=torch.tanh, state_act=torch.sigmoid)
    want = _jax_scan_grads(x, gate_act=jnp.tanh, state_act=jax.nn.sigmoid)
    for name, g, w in zip(("h_seq", "h_f", "dproj", "dw_rz", "dw_c", "dh0"),
                          got, want):
        _close(g, w, "float32", name)


def test_gru_seq_gradients_come_only_from_the_plain_backward(monkeypatch):
    """With the plain backward stubbed out, GruSeq's input gradients are
    the stub's, and the weight gradients are the matmuls outside the
    kernel over the stub's dproj: no other route (autograd through the
    plain forward loop) reaches the inputs."""
    x = _inputs(seed=6, hidden=8)

    def stub(proj, mask, w_rz, w_c, hprev, dh_seq, dh_f):
        return torch.full_like(proj, 2.0), torch.full_like(dh_f, 3.0)

    monkeypatch.setattr(gk, "gru_seq_bwd_reference", stub)
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in _WRT}
    h_seq, h_f = gk.gru_seq(leaves["proj"], torch.from_numpy(x["mask"]),
                            leaves["w_rz"], leaves["w_c"], leaves["h0"])
    (h_seq.sum() + h_f.sum()).backward()
    assert torch.all(leaves["proj"].grad == 2.0)
    assert torch.all(leaves["h0"].grad == 3.0)
    hprev = torch.cat([leaves["h0"][None], h_seq[:-1]]).detach()
    hp = hprev.reshape(-1, 8)
    # dw_rz = hprev^T . 2: every column 2 * sum over rows of hprev
    want_rz = (2.0 * hp.sum(0))[:, None].expand(8, 16)
    torch.testing.assert_close(leaves["w_rz"].grad, want_rz, rtol=1e-5,
                               atol=1e-5)
    # dw_c = (r * hprev)^T . 2 with r recomputed unrounded from hprev
    r = torch.sigmoid(torch.from_numpy(x["proj"])[..., 8:16].reshape(-1, 8)
                      + hp @ torch.from_numpy(x["w_rz"])[:, 8:])
    want_c = (2.0 * (r * hp).sum(0))[:, None].expand(8, 8)
    torch.testing.assert_close(leaves["w_c"].grad, want_c, rtol=1e-5,
                               atol=1e-5)


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def test_update_gate_is_the_first_column_block():
    """One step by hand in numpy with independently drawn update and reset
    weights: columns [0:H] of w_rz feed the update gate u (which keeps the
    old state), columns [H:2H] the reset gate r (which scales h inside the
    candidate). Swapping the two halves changes the answer, so a swap in
    the port would show."""
    rng = np.random.RandomState(7)
    hidden = 5
    proj = rng.randn(1, 2, 3 * hidden).astype(np.float32)
    w_u = rng.randn(hidden, hidden).astype(np.float32)
    w_r = rng.randn(hidden, hidden).astype(np.float32) * 2.0
    w_c = rng.randn(hidden, hidden).astype(np.float32)
    h0 = rng.randn(2, hidden).astype(np.float32)
    u = _sigmoid(proj[0, :, :hidden] + h0 @ w_u)
    r = _sigmoid(proj[0, :, hidden:2 * hidden] + h0 @ w_r)
    c = np.tanh(proj[0, :, 2 * hidden:] + (r * h0) @ w_c)
    want = u * h0 + (1.0 - u) * c
    mask = torch.ones(1, 2)

    def port(w_rz):
        return gk.gru_seq_fwd(torch.from_numpy(proj), mask,
                              torch.from_numpy(w_rz), torch.from_numpy(w_c),
                              torch.from_numpy(h0))[0].numpy()

    np.testing.assert_allclose(port(np.concatenate([w_u, w_r], 1)), want,
                               rtol=1e-5, atol=1e-6)
    assert np.abs(port(np.concatenate([w_r, w_u], 1)) - want).max() > 1e-2
    # the JAX step agrees on the order
    h_jax, _ = jax_rnn.gru_step(jnp.asarray(h0), jnp.asarray(proj[0]),
                                jnp.asarray(np.concatenate([w_u, w_r], 1)),
                                jnp.asarray(w_c), jnp.ones(2),
                                jax.nn.sigmoid, jnp.tanh)
    np.testing.assert_allclose(np.asarray(h_jax), want, rtol=1e-5, atol=1e-6)


def test_masked_rows_carry_h_and_pass_dh_through():
    """A length-0 row keeps h0 at every step, and its dh passes straight
    through: dh0 = dh_f + the sum of its dh_seq, dproj zero."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(seed=8, hidden=16)
         .items()}
    x["mask"][:, 1] = 0.0
    args = [x[k] for k in _FWD]
    h_seq = gk.gru_seq_fwd(*args)
    assert torch.equal(h_seq[:, 1], x["h0"][1].expand(T, 16))
    hprev = torch.cat([x["h0"][None], h_seq[:-1]])
    dh_seq = x["r_seq"]
    dproj, dh0 = gk.gru_seq_bwd(*args[:4], hprev, dh_seq, x["r_h"])
    assert not dproj[:, 1].any()
    torch.testing.assert_close(dh0[1], x["r_h"][1] + dh_seq[:, 1].sum(0),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing(dtype):
    x = _inputs(seed=9, hidden=16)
    args = _torch_arrays(x, dtype)
    before = (gk.launches, gk.bwd_launches)
    h_seq = gk.gru_seq_fwd(*args)
    assert torch.equal(h_seq, gk.gru_seq_fwd_reference(*args))
    hprev = torch.cat([args[-1][None], h_seq[:-1]])
    bwd = args[:4] + [hprev, torch.from_numpy(x["r_seq"]).to(dtype),
                      torch.from_numpy(x["r_h"]).to(dtype)]
    got = gk.gru_seq_bwd(*bwd)
    want = gk.gru_seq_bwd_reference(*bwd)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (gk.launches, gk.bwd_launches) == before
    assert h_seq.dtype == got[0].dtype == got[1].dtype == dtype


@pytest.mark.parametrize("index,bad,match", [
    (0, torch.zeros(T, B, 64), r"\[T, B, 3H\]"),
    (1, torch.zeros(T, B, dtype=torch.float64), "mask_tm must be"),
    (2, torch.zeros(16, 16), "w_rz must be"),
    (3, torch.zeros(16, 16, dtype=torch.bfloat16), "w_c must be"),
    (4, torch.zeros(B + 1, 16), "h0 must be"),
    (0, torch.zeros(T, B, 48, dtype=torch.float16), "float32 or bfloat16"),
])
def test_forward_wrapper_refuses_what_the_kernel_does_not_take(index, bad,
                                                               match):
    args = _torch_arrays(_inputs(seed=10, hidden=16), torch.float32)
    args[index] = bad
    with pytest.raises(EnforceError, match=match):
        gk.gru_seq_fwd(*args)


def test_backward_wrapper_refuses_a_wrong_hprev():
    args = _torch_arrays(_inputs(seed=11, hidden=16), torch.float32)
    with pytest.raises(EnforceError, match="hprev_tm must be"):
        gk.gru_seq_bwd(*args[:4], torch.zeros(T, B, 8),
                       torch.zeros(T, B, 16), torch.zeros(B, 16))


def test_reset_launches():
    gk.reset_launches()
    assert gk.launches == gk.bwd_launches == 0


def test_unported_options_raise():
    from paddle_tpu_torch import data_type, layer
    from paddle_tpu_torch.graph import reset_name_counters

    reset_name_counters()
    words = layer.data(name="w", type=data_type.integer_value_sequence(9))
    emb = layer.embedding(input=words, size=6, name="e")
    # reverse scans are ported (tests/test_torch_crf.py holds them)
    assert layer.grumemory(input=emb, size=2, reverse=True).size == 2
    x = _scan_inputs(seed=12)
    args = (torch.from_numpy(x["proj"]), torch.from_numpy(x["mask"]), None,
            None, torch.from_numpy(x["w_rz"]), torch.from_numpy(x["w_c"]))
    torch_rnn.gru_scan(*args, reverse=True)
    with pytest.raises(EnforceError, match="not ported yet"):
        torch_rnn.gru_scan(*args, reset_bt=torch.zeros(B, T))
