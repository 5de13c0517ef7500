"""The static device-memory footprint of a topology
(paddle_tpu/analyze/topology_check.py, its HBM estimate only): from the
topology's shape math and the parameter payload, no tracing and no
device.

``export_bundle`` records :func:`estimate_hbm_bytes`'s ``total`` for the
largest bucket as the manifest's ``hbm_estimate_bytes``, and the replica
fleets (serve/fleet.py) size ``--replicas auto`` and warn against the
operator's budget, ``PADDLE_TPU_TORCH_HBM_BUDGET`` (:func:`hbm_budget_bytes`).
The components and their formulas are the JAX package's, so the same
topology and payload give the same numbers in both packages.
"""

import os

import numpy as np
import torch

BUDGET_ENV = "PADDLE_TPU_TORCH_HBM_BUDGET"


def hbm_budget_bytes(env=None):
    """The operator's device-memory budget in bytes, from
    ``PADDLE_TPU_TORCH_HBM_BUDGET`` (plain bytes or with a K/M/G/T[B]
    suffix, e.g. ``16G``); None when unset or unparseable."""
    raw = (env if env is not None
           else os.environ.get(BUDGET_ENV, "")).strip()
    if not raw:
        return None
    mult = 1
    up = raw.upper().rstrip("B")
    for suffix, m in (("K", 1024), ("M", 1024 ** 2), ("G", 1024 ** 3),
                      ("T", 1024 ** 4)):
        if up.endswith(suffix):
            up = up[:-1]
            mult = m
            break
    try:
        return int(float(up) * mult)
    except ValueError:
        return None


def _feed_bytes(topology, rows, seq_pad):
    """One dispatch's feed bytes from the data layers: dense [rows, dim]
    f32, index [rows] i32, sequences [rows, T(, dim)] plus their [rows]
    i32 lengths. Sparse slots below ``sparse_feed_threshold`` are fed
    densified and count dense; at or above it they feed as id lists whose
    size depends on the data, and are skipped."""
    from paddle_tpu_torch.data_type import (INDEX, SEQ_NESTED, SEQ_NONE,
                                            SEQ_SINGLE, SPARSE_BINARY,
                                            SPARSE_FLOAT)
    from paddle_tpu_torch.utils import flags

    sparse_threshold = flags.get_flag("sparse_feed_threshold")
    total = 0
    for name, itype in topology.data_types():
        dim = int(itype.dim or 1)
        if itype.seq_type == SEQ_NONE:
            if itype.value_type == INDEX:
                total += rows * 4
            elif itype.value_type in (SPARSE_BINARY, SPARSE_FLOAT) \
                    and dim >= sparse_threshold:
                continue
            else:
                total += rows * dim * 4
        elif itype.seq_type in (SEQ_SINGLE, SEQ_NESTED):
            pad = int((seq_pad or {}).get(name)
                      or max((seq_pad or {}).values(), default=1) or 1)
            per_pos = 4 if itype.value_type == INDEX else dim * 4
            total += rows * pad * per_pos + rows * 4  # data + lengths
    return total


def _optimizer_slot_factor(optimizer):
    """Bytes of optimizer slot state per parameter byte, probed from the
    optimizer's own ``init_slot`` on a small float32 parameter."""
    try:
        leaves = optimizer.init_slot(torch.zeros((2, 3)))
    except Exception:  # noqa: BLE001 — an optimizer that cannot be probed
        return 1.0  # counts as momentum's one slot
    per_byte = 0.0
    for leaf in leaves:
        if tuple(leaf.shape) == (2, 3):
            per_byte += leaf.element_size() / 4.0
    return per_byte


def estimate_hbm_bytes(topology, rows=None, seq_pad=None, parameters=None,
                       optimizer=None, mode="train", steps=1,
                       param_dtypes=None):
    """The static device-memory footprint of one program over
    ``topology``, as ``{component: bytes}``:

    * ``params`` — every parameter tensor; exact (each tensor's own
      bytes) when ``parameters`` is given, else from the specs' shapes at
      ``param_dtypes.get(name, "float32")``, with a float32 scale per
      output column of each int8 tensor;
    * ``replica`` — the half-width copy of the trainable parameters under
      a sub-f32 compute dtype (``mode="train"`` only);
    * ``opt_slots`` — optimizer slots (``init_slot``'s per-byte factor);
    * ``feed`` — one dispatch's feed for ``rows`` rows at the ``seq_pad``
      lengths, times ``steps``;
    * ``activations`` — every non-data layer's [rows, T, size] output in
      the compute dtype, doubled in train mode (a coarse working set);
    * ``resident`` (params + replica + opt_slots + feed) and ``total``
      (resident + activations).

    ``rows=None`` skips the per-dispatch terms."""
    if parameters is not None:
        values = parameters.as_dict()
        name_bytes = {n: int(values[n].nbytes) for n in parameters.names()}
        trainable_names, _static, _state = parameters.partition()
        params_bytes = sum(name_bytes.values())
        trainable_bytes = sum(name_bytes[n] for n in trainable_names)
    else:
        specs = topology.param_specs()
        dtypes = param_dtypes or {}
        sizes = {n: int(np.prod(s.shape) or 1)
                 * np.dtype(dtypes.get(n, "float32")).itemsize
                 for n, s in specs.items()}
        params_bytes = sum(sizes.values())
        params_bytes += sum(
            int(specs[n].shape[-1]) * 4 for n in sizes
            if np.dtype(dtypes.get(n, "float32")) == np.int8
            and len(specs[n].shape) >= 1)
        trainable_bytes = sum(
            b for n, b in sizes.items()
            if not specs[n].is_state
            and not getattr(specs[n].attr, "is_static", False))

    from paddle_tpu_torch.core import dtype as dtype_mod

    cd = dtype_mod.compute_dtype()
    mixed = cd is not None and cd != torch.float32
    replica_bytes = trainable_bytes // 2 if (mode == "train" and mixed) \
        else 0
    opt_bytes = 0
    if mode == "train" and optimizer is not None:
        opt_bytes = int(trainable_bytes * _optimizer_slot_factor(optimizer))

    feed_bytes = act_bytes = 0
    if rows:
        rows = int(rows)
        feed_bytes = (_feed_bytes(topology, rows, seq_pad)
                      * max(int(steps or 1), 1))
        pad = max((seq_pad or {}).values(), default=1) or 1
        elem = 2 if mixed else 4
        act_elems = sum(rows * pad * int(node.size or 0)
                        for node in topology.nodes
                        if node.layer_type != "data")
        act_bytes = act_elems * elem * (2 if mode == "train" else 1)

    resident = params_bytes + replica_bytes + opt_bytes + feed_bytes
    return {
        "params": params_bytes,
        "replica": replica_bytes,
        "opt_slots": opt_bytes,
        "feed": feed_bytes,
        "activations": act_bytes,
        "resident": resident,
        "total": resident + act_bytes,
    }


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return ("%d%s" % (n, unit) if unit == "B"
                    else "%.2f%s" % (n, unit))
        n /= 1024.0
    return "%d" % n
