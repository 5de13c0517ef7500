"""K9, the dequant-fused int8 matmul of quantized bundles, on the CPU: the
port's plain version ``int8_matmul_reference`` against the TPU kernel
``pk._int8_matmul_call`` (Pallas in interpret mode) and against the JAX
package's default XLA path ``pk.int8_matmul``; the wrapper's CPU path and
its guards. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: float32 1e-5 (the two sum the same float32 products in
another order); bfloat16 one bfloat16 step of the output (2^-7 relative,
plus 1e-5 for outputs near zero), since both round the float32 sum once.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.serve.quantize import quantize_int8

from paddle_tpu_torch.ops import int8_kernels as ik
from paddle_tpu_torch.utils.error import EnforceError

BF16_STEP = 2.0 ** -7


def _case(m, k, n, seed, lead=()):
    """x [*lead, m, k] N(0, 1) and a weight N(0, 1/k) quantized by the JAX
    package's scheme (numpy)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, m, k).astype(np.float32)
    q, scale = quantize_int8(rng.randn(k, n) / np.sqrt(k))
    return x, q, scale


def _port(x, q, scale, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(q),
            torch.from_numpy(scale))


@pytest.mark.parametrize("m,k,n", [(5, 72, 256), (3, 37, 128),
                                   (16, 128, 384)])
def test_reference_matches_the_tpu_kernel_f32(m, k, n):
    x, q, scale = _case(m, k, n, seed=m + k)
    want = np.asarray(pk._int8_matmul_call(jnp.asarray(x), jnp.asarray(q),
                                           jnp.asarray(scale)))
    got = ik.int8_matmul_reference(*_port(x, q, scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(5, 72, 256), (7, 40, 128)])
def test_reference_matches_the_tpu_kernel_bf16(m, k, n):
    """The dequantized weight is rounded to bfloat16 before the product in
    both, as the TPU kernel's body does (pallas_kernels.py:911)."""
    x, q, scale = _case(m, k, n, seed=2 * m + k)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pk._int8_matmul_call(xb, jnp.asarray(q),
                                           jnp.asarray(scale))
                      .astype(jnp.float32))
    got = ik.int8_matmul_reference(*_port(x, q, scale, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                               atol=1e-5)


@pytest.mark.parametrize("m,k,n,lead", [(4, 64, 2, ()), (6, 784, 10, ()),
                                        (3, 256, 1000, ()),
                                        (5, 48, 24, (3,))])
def test_wrapper_matches_the_jax_default_path_f32(m, k, n, lead):
    """The wrapper on CPU tensors against pk.int8_matmul's XLA dequant-fused
    dot (its default path), lead dimensions [B, T, K] included."""
    x, q, scale = _case(m, k, n, seed=k + n, lead=lead)
    want = np.asarray(pk.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(scale)))
    before = ik.launches
    got = ik.int8_matmul(*_port(x, q, scale))
    assert ik.launches == before  # the CPU path launches nothing
    assert tuple(got.shape) == lead + (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_wrapper_flattens_a_non_contiguous_input():
    x, q, scale = _case(6, 32, 16, seed=3, lead=(2,))
    xt = torch.from_numpy(x).transpose(0, 1)  # [6, 2, 32], not contiguous
    got = ik.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale))
    want = ik.int8_matmul_reference(xt.reshape(12, 32),
                                    torch.from_numpy(q),
                                    torch.from_numpy(scale))
    assert got.shape == (6, 2, 16)
    torch.testing.assert_close(got.reshape(12, 16), want, rtol=0, atol=0)


def test_wrapper_refuses_to_run_under_grad():
    """Serving only: the TPU kernel has no VJP either."""
    x, q, scale = _port(*_case(2, 8, 4, seed=0))
    x.requires_grad_(True)
    with pytest.raises(EnforceError, match="no gradient"):
        ik.int8_matmul(x, q, scale)
    with torch.no_grad():
        assert ik.int8_matmul(x, q, scale).shape == (2, 4)


@pytest.mark.parametrize("case,match", [
    ("x_f16", "float32 or bfloat16"),
    ("w_float", "w_q must be"),
    ("w_rank", "w_q must be"),
    ("k_mismatch", "x must be"),
    ("scale_shape", "scale must be"),
    ("scale_bf16", "scale must be"),
    ("empty", "empty"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    x, q, scale = _port(*_case(3, 8, 4, seed=1))
    if case == "x_f16":
        x = x.half()
    elif case == "w_float":
        q = q.float()
    elif case == "w_rank":
        q = q.reshape(2, 4, 4)
    elif case == "k_mismatch":
        x = x[:, :5]
    elif case == "scale_shape":
        scale = scale[:3]
    elif case == "scale_bf16":
        scale = scale.bfloat16()
    elif case == "empty":
        x = x[:0]
    with pytest.raises(EnforceError, match=match):
        ik.int8_matmul(x, q, scale)


def test_reset_launches():
    ik._count_launches(2)
    assert ik.launches >= 2
    ik.reset_launches()
    assert ik.launches == 0


# -- the kernel's planner: a pure function of (M, K, N, dtype) --------------

# chip_smoke.py's INT8_CASES: the int8 flagship's products at buckets 32 and
# 1, ResNet-50's fc at buckets 32, 8 and 1, the mlp's products, an odd shape
INT8_CASES = [(2048, 128, 1024), (2048, 256, 1024), (32, 256, 2),
              (64, 128, 1024), (1, 256, 2), (32, 2048, 1000),
              (8, 2048, 1000), (1, 2048, 1000), (8, 784, 128), (8, 128, 64),
              (8, 64, 10), (3, 37, 129)]


def _k_ranges(plan, k):
    per = plan["k_per_split"]
    return [(s * per, min(k, (s + 1) * per)) for s in range(plan["splits"])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_CASES)
def test_plan_path_and_split_cover_k_once(dtype, m, k, n):
    """Split-K for M <= 32, else the tensor cores in bfloat16 and the CUDA
    cores in float32; the K ranges partition [0, K), none empty; the
    workspace holds exactly S partial [M, N] tiles (none when S = 1)."""
    plan = ik.int8_plan(m, k, n, dtype)
    want = ("splitk" if m <= 32
            else "tc_bf16" if dtype == torch.bfloat16 else "simt_f32")
    assert plan["path"] == want
    assert plan == ik.int8_plan(m, k, n, dtype)  # no hidden state
    ranges = _k_ranges(plan, k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    s = plan["splits"]
    assert plan["workspace"] == (s * m * n if s > 1 else 0)
    if want == "splitk":
        assert plan["k_per_split"] % 32 == 0
        assert m <= plan["row_tile"] in (16, 32)
        # column tiles x S: at most about three blocks per SM of 132
        assert -(-n // plan["col_tile"]) * s <= 3 * 132 + -(-n // 64)
    else:
        assert s == 1 and plan["k_per_split"] == k


@pytest.mark.parametrize("m", [1, 8, 32])
def test_plan_spreads_resnet50_fc_over_the_card(m):
    """ResNet-50's fc (K 2048, N 1000): 16 column tiles x S blocks fill the
    132 SMs about three times over, each block a few chunks of K."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = ik.int8_plan(m, 2048, 1000, dtype)
        assert plan["path"] == "splitk"
        assert plan["row_tile"] == (16 if m <= 16 else 32)
        assert 2 * 132 <= 16 * plan["splits"] <= 3 * 132
        assert plan["k_per_split"] <= 128


@pytest.mark.parametrize("sms", [66, 114, 264])
def test_plan_split_follows_the_cards_sm_count(sms):
    """The split-K planner fills about three blocks per SM of the card it is
    given, at ResNet-50's fc (16 column tiles): more splits on more SMs."""
    plan = ik.int8_plan(8, 2048, 1000, torch.float32, sms)
    assert 16 * plan["splits"] <= 3 * sms + 16
    assert plan["splits"] > ik.int8_plan(8, 2048, 1000, torch.float32,
                                         sms // 2)["splits"]


@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (32, 784, 128),
                                   (3, 37, 129), (1, 256, 2)])
def test_split_k_order_matches_the_reference(m, k, n):
    """The split-K path's arithmetic in plain PyTorch: each K range's float32
    partial, added in the order s = 0, 1, ..., S-1, matches the plain
    version within 1e-6 of max(1, max |y|) (float32)."""
    x, q, scale = _port(*_case(m, k, n, seed=m + k + n))
    plan = ik.int8_plan(m, k, n, torch.float32)
    w = q.float() * scale
    total = torch.zeros((m, n))
    for a, b in _k_ranges(plan, k):
        total = total + torch.matmul(x[:, a:b], w[a:b])
    want = ik.int8_matmul_reference(x, q, scale)
    err = float((total - want).abs().max())
    assert err <= 1e-6 * max(1.0, float(want.abs().max()))
