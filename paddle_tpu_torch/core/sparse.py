"""Sparse input rows for high-dimensional sparse slots (paddle_tpu/core/
sparse.py).

A batch of sparse rows is kept as padded id lists: ids [B, K] int32
(-1 pads) and optional values [B, K] float32, with ``dim`` the full
feature width. ``sparse @ W`` is a row gather and a weighted sum over K:

    out[b] = sum_k vals[b, k] * W[ids[b, k]]        (K * size reads)

instead of densifying to [B, dim]. The gradient flows through
``index_select`` back into a dense [dim, size] gradient (a scatter-add,
as the JAX package's ``jnp.take``); with ``ParamAttr(sparse_update=True)``
the optimizer then updates only the touched rows.

K is padded to the next power of two (at least 8), as in the JAX
package, so batches with different nonzero counts share a few shapes.
"""

import numpy as np
import torch

from paddle_tpu_torch.utils.error import enforce

# to_dense refuses wider rows: densifying at that scale is what this type
# exists to avoid
MAX_DENSE_DIM = 262144


def _next_pow2(n, lo=8):
    k = lo
    while k < n:
        k *= 2
    return k


class SparseRows:
    """A batch of sparse feature rows: ids [B, K] int32 (-1 = padding),
    vals [B, K] float32 or None (binary), dim = full feature width."""

    __slots__ = ("ids", "vals", "dim")

    def __init__(self, ids, vals, dim):
        self.ids = ids
        self.vals = vals
        self.dim = int(dim)

    @property
    def size(self):
        return self.dim

    @classmethod
    def from_rows(cls, rows, dim, with_values, device=None):
        """rows: id lists (binary) or (id, value)-pair lists; the tensors
        go to ``device`` (default the CPU)."""
        lens = [len(r) for r in rows]
        k = _next_pow2(max(lens, default=1))
        b = len(rows)
        ids = np.full((b, k), -1, np.int32)
        vals = np.zeros((b, k), np.float32) if with_values else None
        # one numpy assignment for all rows: the mask picks each row's
        # first len(row) slots, in row order
        filled = np.arange(k)[None, :] < np.asarray(lens)[:, None]
        total = sum(lens)
        if with_values:
            ids[filled] = np.fromiter((int(i) for r in rows for i, _ in r),
                                      np.int64, count=total)
            vals[filled] = np.fromiter(
                (float(v) for r in rows for _, v in r), np.float64,
                count=total)
        else:
            ids[filled] = np.fromiter((int(i) for r in rows for i in r),
                                      np.int64, count=total)
        return cls(torch.as_tensor(ids, device=device),
                   None if vals is None
                   else torch.as_tensor(vals, device=device), dim)

    def map_vals(self, fn):
        """The same rows with ``fn`` applied to the values (the dtype
        policy's cast at the topology boundary); ids are left as they
        are."""
        return SparseRows(self.ids, None if self.vals is None
                          else fn(self.vals), self.dim)

    def weights(self):
        """[B, K] float32 combination weights (mask * values)."""
        m = (self.ids >= 0).float()
        return m if self.vals is None else m * self.vals

    def matmul(self, w):
        """sparse_rows @ w for w [dim, size]: gather + weighted K-sum. An
        int8 table is gathered as int8 and only the [B, K, size] slice is
        converted to float32; the caller applies the per-output-channel
        scale to the result (it commutes past the K-sum)."""
        enforce(w.shape[0] == self.dim,
                "sparse matmul: weight rows %d != sparse dim %d",
                w.shape[0], self.dim)
        safe = torch.clamp(self.ids, min=0).long()
        b, k = safe.shape
        rows = torch.index_select(w, 0, safe.reshape(-1)).reshape(
            b, k, w.shape[1])
        if rows.dtype == torch.int8:
            rows = rows.float()
        wts = self.weights().to(rows.dtype)
        return torch.sum(rows * wts[..., None], dim=1)

    def to_dense(self):
        """[B, dim] dense rows for layers without a sparse fast path.
        Refused above MAX_DENSE_DIM dims."""
        enforce(self.dim <= MAX_DENSE_DIM,
                "refusing to densify a %d-dim sparse batch (use a layer "
                "with a sparse fast path — fc — or lower the dim)",
                self.dim)
        safe = torch.clamp(self.ids, min=0).long()
        wts = self.weights()
        out = torch.zeros((safe.shape[0], self.dim), dtype=wts.dtype,
                          device=safe.device)
        return out.scatter_add_(1, safe, wts)
