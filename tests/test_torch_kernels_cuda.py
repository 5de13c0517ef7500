"""The hand-written LSTM and GRU kernels, forward and backward, against
their plain versions ON THE CARD.

Needs an NVIDIA card and nvcc; skips with a reason elsewhere. This file
imports neither JAX nor paddle_tpu, so it also runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.ops import lstm_kernels as lk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode "
                    "(tests/test_torch_lstm.py, test_torch_lstm_bwd.py and "
                    "test_torch_gru.py cover their plain versions)")
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
@pytest.mark.parametrize("batch,hidden", [(3, 40), (64, 256), (64, 1280),
                                          (128, 1280)])
def test_bwd_kernel_matches_plain_version_on_card(cuda_device, dtype, tol,
                                                  batch, hidden):
    """The backward kernel against its plain version on the card: dgates,
    dh0, dc0 absolute, dpeep (a sum over B and T) relative to its size.
    The tolerance covers the different summation order of both GEMVs (and,
    in bfloat16, a flipped rounding of dz feeding through the dh carry).
    B=128 at H=1280 needs more blocks than one co-resident grid holds, so
    the wrapper runs it as several launches of row chunks."""
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
    launch = lk.lstm_seq_bwd.last_launch
    assert lk.bwd_launches == before + launch["launches"]
    if batch <= 64:
        assert launch["launches"] == 1, launch
    if hidden == 1280 and batch == 128:
        assert launch["launches"] >= 2, launch
    want = lk.lstm_seq_bwd_reference(*args)
    for name, g, w in zip(("dgates", "dh0", "dc0"), got[:3], want[:3]):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    scale = float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=tol * scale,
                               msg=lambda m: "dpeep: %s" % m)


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
