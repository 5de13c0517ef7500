"""The dequant-fused matmul of quantized serving bundles: the hand-written
CUDA kernel and its plain PyTorch version.

``int8_matmul`` has the function of paddle_tpu/ops/pallas_kernels.py
``int8_matmul`` when it takes the TPU kernel K9 ``_int8_matmul_kernel``:

    x      [..., K]  float32 or bfloat16
    w_q    [K, N]    int8, per-output-channel symmetric (serve/quantize.py)
    scale  [N]       float32
    -> y   [..., N]  in x's dtype,
    y = x @ round_to_x_dtype(float32(w_q) * scale)

with every product summed in float32 and the result rounded once to x's
dtype. The lead dimensions are flattened to a contiguous [M, K] for the
kernel and restored after it.

On a CUDA tensor the wrapper launches the kernel (csrc/int8_matmul.cu) or
raises; on a CPU tensor it runs the plain version beside it
(``int8_matmul_reference``), which is also the oracle the kernel is held
against. In bfloat16 the plain version rounds the dequantized weight to
bfloat16 before the product, as the TPU kernel does: the JAX package's
XLA path (pallas_kernels.py:959) rounds the scale instead, and the two
differ by up to one bfloat16 step.

Serving only: the TPU kernel has no VJP, and the wrapper raises when x
asks for a gradient.

Not ported: the JAX package's ``int8_matmul`` flag, ``int8_matmul_mode``
and the ``_INT8_MEASURED_WINS`` gate. They choose between the Pallas kernel
and XLA's dequant-fused dot by TPU conditions (N a multiple of 128, K a
multiple of 8, the VMEM budget, a recorded on-chip win); here every int8
product on the card runs the kernel, at any M, K, N >= 1.

The kernel has three paths, and ``int8_plan`` picks one from (M, K, N,
dtype) alone (no flag, no environment variable): split-K on the CUDA cores
for M <= 32 (the served fc layers: the weight's bytes bound them), the
tensor cores for bfloat16 and the CUDA cores in 128 x 64 tiles for
float32 above that (the arithmetic rate bounds them); see
csrc/int8_matmul.cu. Split-K sums S contiguous K ranges into a float32
workspace ``[S, M, N]`` that the wrapper allocates, and a second pass in
the same call adds them in the order s = 0, 1, ..., S-1: deterministic.

``launches`` counts the kernel's launches since the last
``reset_launches()`` (a launch made to compare the kernel with its plain
version counts too; callers reset around the path they read). A call
counts as one launch, split-K's second pass included.
"""

import threading

import torch

from paddle_tpu_torch.ops._build import (DTYPE_CODES, H100_SMS, aligned,
                                         check_args, launch, sm_count)
from paddle_tpu_torch.utils.error import enforce

launches = 0
_count_lock = threading.Lock()


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def _count_launches(n):
    global launches
    with _count_lock:
        launches += n


def int8_matmul_reference(x, w_q, scale):
    """The plain PyTorch version of K9 (float32 products and sums, the
    dequantized weight rounded to x's dtype first, one rounding of the
    result)."""
    w = (w_q.float() * scale).to(x.dtype).float()
    return torch.matmul(x.float(), w).to(x.dtype)


SPLITK_MAX_M = 32
# about three split-K blocks per SM
_SPLITK_BLOCKS_PER_SM = 3
_SPLITK_COLS, _SPLITK_CHUNK = 64, 32
_PATHS = {"splitk": 0, "tc_bf16": 1, "simt_f32": 2}


def _ceil(a, b):
    return -(-a // b)


def int8_plan(m, k, n, dtype, sms=H100_SMS):
    """The kernel's path and tiling for x [m, k] of ``dtype`` and w_q
    [k, n] on a card of ``sms`` SMs, from the shapes and dtype alone:
    ``path`` ("splitk", "tc_bf16" or "simt_f32"), ``row_tile`` and
    ``col_tile`` (the block's outputs), ``splits`` S and ``k_per_split``
    (split s sums k in [s * k_per_split, min(k, (s + 1) * k_per_split)),
    every range non-empty), and ``workspace`` (float32 entries of the
    partials, S * m * n, or 0 when S = 1)."""
    m, k, n = int(m), int(k), int(n)
    if m <= SPLITK_MAX_M:
        col_tiles = _ceil(n, _SPLITK_COLS)
        chunks = _ceil(k, _SPLITK_CHUNK)
        want = min(chunks, _ceil(_SPLITK_BLOCKS_PER_SM * sms, col_tiles))
        k_per_split = _ceil(chunks, want) * _SPLITK_CHUNK
        splits = _ceil(k, k_per_split)
        return {"path": "splitk", "row_tile": 16 if m <= 16 else 32,
                "col_tile": _SPLITK_COLS, "splits": splits,
                "k_per_split": k_per_split,
                "workspace": splits * m * n if splits > 1 else 0}
    if dtype == torch.bfloat16:
        return {"path": "tc_bf16", "row_tile": 64, "col_tile": 64,
                "splits": 1, "k_per_split": k, "workspace": 0}
    return {"path": "simt_f32", "row_tile": 128, "col_tile": 64,
            "splits": 1, "k_per_split": k, "workspace": 0}


def int8_matmul(x, w_q, scale):
    """K9: ``x @ dequant(w_q, scale)`` for x [..., K], w_q [K, N] int8 and
    scale [N] float32 (see module docstring). After a kernel call,
    ``int8_matmul.last_launch`` holds the plan and the grid the kernel
    used."""
    enforce(x.dtype in DTYPE_CODES, "int8_matmul takes float32 or bfloat16 "
            "x, got %s", x.dtype)
    enforce(not (torch.is_grad_enabled() and x.requires_grad),
            "int8_matmul serves quantized bundles only: it has no gradient")
    enforce(w_q.dim() == 2, "int8_matmul: w_q must be [K, N], got %s",
            tuple(w_q.shape))
    k, n = w_q.shape
    enforce(x.dim() >= 1 and x.shape[-1] == k,
            "int8_matmul: x must be [..., %d], got %s", k, tuple(x.shape))
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k).contiguous()
    check_args("int8_matmul", x2, [("w_q", w_q, (k, n), torch.int8),
                                   ("scale", scale, (n,), torch.float32)])
    return int8_matmul_op(x2, w_q, scale).reshape(lead + (n,))


def _launch(x2, w_q, scale):
    """One call of K9 on checked inputs x2 [M, K] (a CUDA tensor, else
    raises) -> [M, N]."""
    dev = x2.device
    enforce(dev.type == "cuda", "int8_matmul runs on cuda or cpu tensors, "
            "got %s", dev)
    m, k = x2.shape
    n = w_q.shape[1]
    plan = int8_plan(m, k, n, x2.dtype, sm_count(dev))
    y = torch.empty((m, n), dtype=x2.dtype, device=dev)
    ws = torch.empty((plan["workspace"],), dtype=torch.float32, device=dev)
    info = launch("int8_matmul", dev,
                  (aligned(x2), aligned(w_q), scale.contiguous()), (y, ws),
                  (m, k, n, _PATHS[plan["path"]], plan["row_tile"],
                   plan["splits"], plan["k_per_split"]), _count_launches)
    int8_matmul.last_launch = dict(plan, **dict(zip(
        ("column_tiles", "row_tiles", "grid_splits", "weight_load_bytes",
         "smem_bytes", "launches"), info)))
    return y


@torch.library.custom_op("paddle_tpu_torch::int8_matmul", mutates_args=(),
                         device_types="cpu")
def int8_matmul_op(x2: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """K9 as a registered op over x2 [M, K]: the plain version on the CPU,
    the kernel on the card (``_launch``, which counts the launches), the
    output shape alone while a program is traced."""
    return int8_matmul_reference(x2, w_q, scale)


int8_matmul_op.register_kernel("cuda")(_launch)


@int8_matmul_op.register_fake
def _int8_matmul_fake(x2, w_q, scale):
    return x2.new_empty((x2.shape[0], w_q.shape[1]))


int8_matmul.last_launch = None
