"""What the cluster layouts of the recurrent kernels (csrc/lstm_seq_fwd.cu,
csrc/lstm_seq_bwd.cu, csrc/gru_seq_fwd.cu, csrc/gru_seq_bwd.cu) plan by:
the card's limits, as the library of the kernel being planned reads them,
the rows per block of one thread-block cluster per batch tile, and the
shared memory of the forward kernels' product step (csrc/fwd_cluster.cuh).

A cluster holds ceil(H / 32) blocks, one per unit tile (at most 16; above
8 a non-portable size), each serving 1, 2, 4, 5 or 8 batch rows. These
constants copy the kernels' (kClMaxTiles, fwdcl::kMaxTiles,
sm90::kPortableClusterSize, the rows the kernels are compiled for, and
fwd_cluster.cuh's kRegK and kXPad); tests/test_torch_lstm_bwd.py,
tests/test_torch_gru_bwd_plan.py and tests/test_torch_fwd_plan.py hold
them equal.
"""

import ctypes

import torch

from paddle_tpu_torch.ops._build import load
from paddle_tpu_torch.utils.error import enforce

# an H100 SXM's opt-in shared memory per block, and the clusters of 8 and
# of 16 one-block-per-SM blocks it holds at once
# (cudaOccupancyMaxActiveClusters): the planners' defaults, which the CPU
# tests plan for; the card's own come from ``device_limits``
H100_SMEM_OPTIN = 232448
H100_CLUSTERS = (15, 7)
MAX_TILES = 16
PORTABLE = 8
ROWS = (1, 2, 4, 5, 8)
# the forward cluster kernels are also compiled for 3 rows (B=32 then runs
# as 11 clusters of the 15 an H100 holds, not 8)
FWD_ROWS = (1, 2, 3, 4, 5, 8)
# the forward product's K where W sits in registers (clusters of at most 8
# blocks: zero-padded to 8 warps x 32), and the floats past K in a row of
# the block's state buffers
FWD_REG_K = 256
FWD_XPAD = 8
_limits = {}


def fwd_k_len(tiles):
    """K of a forward cluster block's product (fwdcl::k_len)."""
    return FWD_REG_K if tiles <= PORTABLE else 32 * tiles


def fwd_w_bytes(tiles, cols, esz):
    """Bytes of a forward cluster block's W slice of ``cols`` columns in
    shared memory: none where it sits in registers (fwdcl::w_bytes)."""
    return 0 if tiles <= PORTABLE else fwd_k_len(tiles) * cols * esz


def fwd_scratch_floats(cols, rows, esz):
    """Floats of the scratch of a ``cols``-column forward product at
    ``rows`` rows (fwdcl::scratch_floats): the 8 warps' partial sums in
    float32; in bfloat16 the tile, once per K part."""
    if esz == 4:
        return 8 * cols * rows
    tiles8 = cols // 8
    return (1 if tiles8 >= 8 else 8 // tiles8) * cols * rows


def fwd_state_bytes(tiles, rows, buffers):
    """Bytes of ``buffers`` float32 state buffers of ``rows`` rows at the
    pitch fwdcl::x_pitch."""
    return 4 * buffers * rows * (fwd_k_len(tiles) + FWD_XPAD)


def device_limits(name, dev):
    """(SM count, opt-in shared memory per block in bytes, (clusters of 8,
    clusters of 16)) of the card ``dev``, as the C entry ``<name>_limits``
    of kernel library ``name`` reads them for its own cluster kernel: the
    cluster counts are how many clusters of that many one-block-per-SM
    blocks the card holds at once (0: it cannot launch such a cluster)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (name, index)
    if key not in _limits:
        fn = getattr(load(name), name + "_limits")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 4)()
        rc = fn(index, out)
        enforce(rc == 0, "%s: reading the limits of cuda:%d failed (code "
                "%d)", name, index, rc)
        _limits[key] = (out[0], out[1], (out[2], out[3]))
    return _limits[key]


def cluster_slots(hidden, clusters):
    """How many clusters of ceil(H / 32) blocks the card holds at once
    (``clusters`` = (of 8, of 16), as ``device_limits`` reads them)."""
    tiles = -(-hidden // 32)
    return (clusters[0] * (PORTABLE // tiles) if tiles <= PORTABLE
            else clusters[1])


def cluster_rows(batch, hidden, smem_of, smem, clusters, rows=ROWS):
    """The rows per block of a cluster layout, or None where it does not
    take ``hidden``: H % 8 == 0, ceil(H / 32) <= 16 blocks per cluster, a
    card that holds such a cluster (``clusters`` = (of 8, of 16), as
    ``device_limits`` reads them), and a block that fits in ``smem`` bytes
    (``smem_of(rows)``). The smallest R of ``rows`` (the counts the kernel
    is compiled for) whose ceil(B / R) clusters the card holds at once
    (clusters of k <= 8 blocks: (8 // k) x those of 8), or where none is,
    the largest that fits."""
    if hidden % 8 or -(-hidden // 32) > MAX_TILES:
        return None
    slots = cluster_slots(hidden, clusters)
    fits = [r for r in rows if smem_of(r) <= smem]
    if not slots or not fits:
        return None
    return next((r for r in fits if -(-batch // r) <= slots), fits[-1])
