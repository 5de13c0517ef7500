"""What the cluster layouts of the recurrent backward kernels
(csrc/lstm_seq_bwd.cu and csrc/gru_seq_bwd.cu) plan by: the card's limits,
as the library of the kernel being planned reads them, and the rows per
block of one thread-block cluster per batch tile.

A cluster holds ceil(H / 32) blocks, one per unit tile (at most 16; above
8 a non-portable size), each serving 1, 2, 4, 5 or 8 batch rows. These
constants copy the kernels' (kClMaxTiles, sm90::kPortableClusterSize, the
rows the kernels are compiled for); tests/test_torch_lstm_bwd.py and
tests/test_torch_gru_bwd_plan.py hold them equal.
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
_limits = {}


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


def cluster_rows(batch, hidden, smem_of, smem, clusters):
    """The rows per block of a cluster layout, or None where it does not
    take ``hidden``: H % 8 == 0, ceil(H / 32) <= 16 blocks per cluster, a
    card that holds such a cluster (``clusters`` = (of 8, of 16), as
    ``device_limits`` reads them), and a block that fits in ``smem`` bytes
    (``smem_of(rows)``). The smallest R whose ceil(B / R) clusters the
    card holds at once (clusters of k <= 8 blocks: (8 // k) x those of 8),
    or where none is, the largest that fits."""
    tiles = -(-hidden // 32)
    if hidden % 8 or tiles > MAX_TILES:
        return None
    slots = (clusters[0] * (PORTABLE // tiles) if tiles <= PORTABLE
             else clusters[1])
    fits = [r for r in ROWS if smem_of(r) <= smem]
    if not slots or not fits:
        return None
    return next((r for r in fits if -(-batch // r) <= slots), fits[-1])
