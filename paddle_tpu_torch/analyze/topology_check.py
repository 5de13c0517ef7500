"""Pre-dispatch topology checks: shapes, packing legality, the parameter
partition, the programs a run will capture and the device-memory
footprint — no tracing, no device (paddle_tpu/analyze/topology_check.py).

Everything here works from two static sources: the layer *sources* (AST)
and the built :class:`~paddle_tpu_torch.topology.Topology` graph, so the
checks are safe to run at train start (``PADDLE_TPU_TORCH_ANALYZE=1``)
and in CI (``cli analyze --topology``).

* **Cross-position layer derivation** (:func:`scan_layer_modules`): walks
  ``paddle_tpu_torch/layer/*.py`` and classifies every registered layer
  by how its forward consumes sequence structure — structure methods
  (``last_step``/``reduce``/...), sequence lengths or masks handed to an
  ops function (``seq_ops.context_projection(x.data, x.mask(), ...)``),
  length arithmetic. The JAX package's rules, with two of the port's
  idioms: a layer that delegates to a projection object of a sibling
  layer module (``context_projection(...).forward``) is read through that
  class's methods, and ``ops/detection.py``'s functions (``det_ops``)
  are not time-position signals — they read a detection label as the set
  of one image's instances, aligned row for row with the image
  predictions (``multibox_loss`` refuses a label whose rows are not the
  images', as the JAX package's per-image vmap does), so the segments of
  a packed label row are instances of that row's image.
  :func:`verify_reject_packed_coverage` compares the DERIVED set with
  the ``reject_packed`` call sites.
* **Graph checks** (:func:`check_topology`): packing legality, index
  feeds consumed by float layers, label feeds that mixed precision would
  quantize, and the parameter partition (JAX's donation carries; the
  port's in-place training state) — every parameter in exactly one of
  trainable, static and running state.
* **Program prediction** (:func:`predict_jit_entries`): the exact batch,
  bucket and chunk stream a ``(topology, buckets, steps_per_call)``
  combination produces, using the real ``rebucket_batches`` and
  ``DeviceFeeder.chunks``' grouping rule on host data, and the programs
  it makes: on the port, under ``steps_per_call``, the CUDA graphs the
  card run captures (``analyze.max_retraces`` pins the live count).
* **The memory estimate** (:func:`estimate_hbm_bytes`): ``export_bundle``
  records its ``total`` for the largest bucket as the manifest's
  ``hbm_estimate_bytes``, and the replica fleets (serve/fleet.py) size
  ``--replicas auto`` and warn against the operator's budget,
  ``PADDLE_TPU_TORCH_HBM_BUDGET`` (:func:`hbm_budget_bytes`). The
  components and formulas are the JAX package's, so the same topology
  and payload give the same numbers in both packages.
"""

import ast
import os
from functools import lru_cache

import numpy as np
import torch

from paddle_tpu_torch.analyze.lint import _call_name

# Methods of SequenceBatch/NestedSequenceBatch whose use means the layer
# consumes sequence STRUCTURE (reduces or regroups over time), not just
# per-position features.
STRUCTURE_METHODS = {
    "last_step", "first_step", "masked_data", "flatten_to_subsequences",
    "outer_sequence_of", "outer_mask", "reduce",
}
# Wrappers where passing ``.lengths`` verbatim is position-preserving
# bookkeeping (rewrapping the same time axis), not time math.
SEQ_WRAPPERS = {"SequenceBatch", "PackedSequenceBatch",
                "NestedSequenceBatch", "like"}
# References that mean the layer UNDERSTANDS packed segments (carries
# reset at segment starts etc.) — cross-position but packing-legal.
PACKING_AWARE_MARKS = {"reset_mask", "segments", "PackedSequenceBatch"}
# Ops modules whose functions read a sequence as a per-row instance set
# aligned with the row's image (ops/detection.py), not as a time axis.
SET_OPS_MODULES = {"det_ops"}

# Node types through which an integer id feed may legally flow without a
# silent int->float promotion (they embed, compare, count or print ids —
# never matmul them).
INDEX_SAFE_TYPES = {
    "embedding", "table_projection", "max_id", "eos_id", "sampling_id",
    "print", "crf", "crf_decoding", "ctc", "data",
}

LAYER_PACKAGE = "paddle_tpu_torch.layer"


def _annotate_parents(tree):
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._pta_parent = node


def _registered_name(func_node):
    """The register_layer("name") decorator argument, or None."""
    for deco in func_node.decorator_list:
        if isinstance(deco, ast.Call) \
                and _call_name(deco.func) == "register_layer" \
                and deco.args and isinstance(deco.args[0], ast.Constant):
            return deco.args[0].value
    return None


def _node_type_of(func_node, default):
    """The make_node("type", ...) string inside a registered layer."""
    for node in ast.walk(func_node):
        if isinstance(node, ast.Call) \
                and _call_name(node.func) == "make_node" \
                and node.args and isinstance(node.args[0], ast.Constant):
            return node.args[0].value
    return default


def _is_wrapper_arg(attr_node):
    """True when ``.lengths`` is a direct argument of a sequence wrapper
    call — rewrapping, not time arithmetic."""
    parent = getattr(attr_node, "_pta_parent", None)
    return (isinstance(parent, ast.Call)
            and _call_name(parent.func) in SEQ_WRAPPERS
            and attr_node in parent.args)


def _struct_arg(node):
    """True when a call argument carries sequence structure:
    ``x.lengths`` or ``x.mask()``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "lengths":
            return True
        if isinstance(sub, ast.Call) and _call_name(sub.func) == "mask":
            return True
    return False


def _cross_position_signals(forward_node):
    """[(line, reason)] static signals that a forward mixes across time
    positions."""
    signals = []
    for node in ast.walk(forward_node):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in STRUCTURE_METHODS:
                signals.append((node.lineno,
                                "structure method .%s()" % name))
            elif isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id.endswith("_ops") \
                    and node.func.value.id not in SET_OPS_MODULES \
                    and any(_struct_arg(a) for a in node.args):
                signals.append((node.lineno,
                                "lengths/mask handed to ops kernel %s.%s"
                                % (node.func.value.id, name)))
        elif isinstance(node, ast.Attribute) and node.attr == "lengths":
            parent = getattr(node, "_pta_parent", None)
            if isinstance(parent, (ast.BinOp, ast.Compare, ast.UnaryOp,
                                   ast.Subscript)):
                signals.append((node.lineno, "arithmetic on .lengths"))
            elif isinstance(parent, ast.Call) \
                    and not _is_wrapper_arg(node) \
                    and node in parent.args:
                signals.append((node.lineno,
                                ".lengths consumed by %s()"
                                % (_call_name(parent.func) or "call")))
    return signals


def _parse(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    _annotate_parents(tree)
    return tree


def _local_imports(func_node):
    """{name: sibling layer module file} for ``from
    paddle_tpu_torch.layer.<mod> import name`` inside a function."""
    out = {}
    for node in ast.walk(func_node):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith(LAYER_PACKAGE + "."):
            mod = node.module[len(LAYER_PACKAGE) + 1:]
            for alias in node.names:
                out[alias.asname or alias.name] = mod + ".py"
    return out


def _layer_subtrees(func_node, module_defs, sibling):
    """The registered function plus the helpers it calls (one level): a
    module-level function (recurrent layers keep their packed-segment
    handling in a shared module helper), a class of the module, or a
    function or class imported from a sibling layer module inside the
    function — a class counts with all its methods (a layer that builds
    a projection object and calls its ``forward``)."""
    trees = [func_node]
    imported = _local_imports(func_node)
    for node in ast.walk(func_node):
        if not (isinstance(node, ast.Call) and isinstance(node.func,
                                                          ast.Name)):
            continue
        name = node.func.id
        helper = module_defs.get(name)
        if helper is None and name in imported:
            helper = sibling(imported[name]).get(name)
        if helper is None or helper is func_node or helper in trees:
            continue
        trees.append(helper)
    return trees


def _module_defs(tree):
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@lru_cache(maxsize=1)
def scan_layer_modules(layer_dir=None):
    """Classify every registered layer in ``paddle_tpu_torch/layer``:
    {registered_name: {node_type, file, line, cross_position, reasons,
    packing_aware, rejects_packed}}."""
    if layer_dir is None:
        import paddle_tpu_torch.layer

        layer_dir = os.path.dirname(
            os.path.abspath(paddle_tpu_torch.layer.__file__))
    parsed = {}

    def sibling(fname):
        if fname not in parsed:
            path = os.path.join(layer_dir, fname)
            parsed[fname] = (_module_defs(_parse(path))
                             if os.path.isfile(path) else {})
        return parsed[fname]

    out = {}
    for fname in sorted(os.listdir(layer_dir)):
        if not fname.endswith(".py"):
            continue
        tree = _parse(os.path.join(layer_dir, fname))
        module_defs = _module_defs(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            reg = _registered_name(node)
            if reg is None:
                continue
            trees = _layer_subtrees(node, module_defs, sibling)
            signals = [s for t in trees
                       for s in _cross_position_signals(t)]
            marks = {
                sub.attr if isinstance(sub, ast.Attribute) else sub.id
                for t in trees for sub in ast.walk(t)
                if isinstance(sub, (ast.Attribute, ast.Name))
            }
            out[reg] = {
                "node_type": _node_type_of(node, reg),
                "file": fname,
                "line": node.lineno,
                "cross_position": bool(signals),
                "reasons": signals,
                "packing_aware": bool(marks & PACKING_AWARE_MARKS),
                "rejects_packed": any(
                    isinstance(sub, ast.Call)
                    and _call_name(sub.func) == "reject_packed"
                    for t in trees for sub in ast.walk(t)),
            }
    return out


def verify_reject_packed_coverage():
    """Compare the DERIVED cross-position layer set against the actual
    reject_packed call sites: ``expected`` (layers that must refuse
    packed input: cross-position, not packing-aware), ``covered`` (layers
    that do), ``missing`` (would silently mix segments) and ``extra``
    (over-covered; harmless, listed so a lost static signal shows)."""
    info = scan_layer_modules()
    expected = {name for name, i in info.items()
                if i["cross_position"] and not i["packing_aware"]}
    covered = {name for name, i in info.items() if i["rejects_packed"]}
    return {
        "expected": sorted(expected),
        "covered": sorted(covered),
        "missing": sorted(expected - covered),
        "extra": sorted(covered - expected),
    }


def packed_rejecting_node_types():
    """Topology node types that refuse packed input (derived)."""
    info = scan_layer_modules()
    return {i["node_type"] for i in info.values()
            if i["rejects_packed"]
            or (i["cross_position"] and not i["packing_aware"])}


# -- graph checks ------------------------------------------------------------

def check_topology(topology, parameters=None, steps_per_call=None):
    """Static report on a built Topology: packing legality, dtype
    hazards, the parameter partition. Returns a dict with ``errors``
    (would fail or corrupt at run time) and ``warnings`` (probable
    mistakes), plus ``packing`` and, with ``parameters``, ``donation``
    (the JAX package's key: its carries are donated, the port's training
    state is updated in place; ``replica`` is the half-width copy of the
    masters a sub-f32 compute dtype makes)."""
    from paddle_tpu_torch.data_type import INDEX, SEQ_NESTED, SEQ_SINGLE
    from paddle_tpu_torch.layer.cost import COST_LAYER_TYPES

    report = {"errors": [], "warnings": []}
    consumers = topology.consumers

    rejecting = packed_rejecting_node_types()
    reject_nodes = [{"layer": n.name, "type": n.layer_type}
                    for n in topology.nodes if n.layer_type in rejecting]
    has_seq = any(itype.seq_type in (SEQ_SINGLE, SEQ_NESTED)
                  for _, itype in topology.data_types())
    report["packing"] = {
        "packed_legal": has_seq and not reject_nodes,
        "rejecting_layers": reject_nodes,
    }

    for name, itype in topology.data_types():
        if itype.value_type != INDEX:
            continue
        for node, _pos in consumers.get(name, ()):  # direct consumers
            t = node.layer_type
            if t in INDEX_SAFE_TYPES or t in COST_LAYER_TYPES \
                    or t.endswith("_evaluator"):
                continue
            report["warnings"].append(
                "index feed %r consumed directly by %r (%s): integer ids "
                "will silently promote to float — embed them instead"
                % (name, node.name, t))

    # label feeds mixed precision would quantize: consumed by a cost at
    # input position >= 1 AND by at least one non-cost layer
    for name in topology.data_layers:
        uses = consumers.get(name, ())
        cost_label = any(n.layer_type in COST_LAYER_TYPES and pos >= 1
                         for n, pos in uses)
        other = [n.name for n, pos in uses
                 if not (n.layer_type in COST_LAYER_TYPES and pos >= 1)]
        if cost_label and other:
            report["warnings"].append(
                "feed %r is a cost label but also feeds %s: under a bf16 "
                "compute dtype the shared feed is quantized — duplicate "
                "the data layer to keep supervision full-precision"
                % (name, other))

    # the parameter partition: every parameter in exactly one group
    if parameters is not None:
        trainable, static, state = parameters.partition()
        groups = {"trainable": set(trainable), "static": set(static),
                  "state": set(state)}
        names = sorted(groups)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                overlap = groups[a] & groups[b]
                if overlap:
                    report["errors"].append(
                        "parameter(s) %s in both the %s and %s carries: "
                        "the same buffer would be donated twice"
                        % (sorted(overlap), a, b))
        from paddle_tpu_torch.core import dtype as dtype_mod

        cd = dtype_mod.compute_dtype()
        report["donation"] = {
            "trainable": len(trainable), "static": len(static),
            "state": len(state),
            "replica": bool(cd is not None and cd != torch.float32),
        }
        if steps_per_call and int(steps_per_call) > 1:
            report["donation"]["steps_per_call"] = int(steps_per_call)

    return report


# -- static device-memory footprint -------------------------------------------

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


# -- program prediction -------------------------------------------------------

def _chunk_plan(keys, k):
    """Mirror of DeviceFeeder.chunks' grouping rule (data/feeder.py) on a
    host stream of shape keys: consecutive equal keys group up to ``k``;
    a key change or the stream end closes the open group. Yields (key,
    steps)."""
    group_key, size = None, 0
    for key in keys:
        if size and key != group_key:
            yield group_key, size
            size = 0
        group_key = key
        size += 1
        if size == k:
            yield group_key, size
            size = 0
    if size:
        yield group_key, size


def predict_jit_entries(topology, reader, buckets=None, steps_per_call=None,
                        feeding=None, drop_remainder=False,
                        parameters=None, optimizer=None):
    """The programs a ``(topology, buckets, steps_per_call)`` combination
    makes over ``reader``'s batch stream, computed by running the real
    bucketing regrouping and the feeder's chunk-grouping rule on host
    data only (no conversion, no tracing, no device).

    ``reader`` is the trainer's minibatch reader (zero-arg callable).
    Returns ``{"entries": [...], "programs": N, "hbm_peak_bytes": B}``
    where each entry is ``{"kind": "step"|"scan", "rows": R, "seq_pad":
    {slot: T}, "hbm": {...}, and for scans "steps": K}`` (the JAX
    package's dict). ``hbm`` is each program's static footprint
    (:func:`estimate_hbm_bytes`; pass ``parameters``/``optimizer`` for
    exact parameter and slot bytes).

    ``programs`` on the port: under ``steps_per_call`` (K >= 1), the CUDA
    graphs the card run captures — one per entry, a ``scan`` entry a
    K-step capture and a ``step`` entry a 1-step capture (a chunk of one
    batch: a shape boundary, the pass's last); the live count is what
    ``analyze.max_retraces`` pins. Without ``steps_per_call`` the steps
    run eagerly and capture nothing, and ``programs`` is an upper bound:
    the per-step shapes the run will see."""
    from paddle_tpu_torch.core.sequence import bucket_length
    from paddle_tpu_torch.data import bucketing
    from paddle_tpu_torch.data_type import SEQ_SINGLE

    if buckets is not None and buckets is not False:
        opts = dict(buckets) if isinstance(buckets, dict) else {
            "boundaries": None if buckets is True else list(buckets)}
        reader = bucketing.rebucket_batches(
            reader, buckets=opts.get("boundaries"),
            drop_remainder=bool(opts.get("drop_remainder",
                                         drop_remainder)),
            length_of=bucketing.topology_length_of(topology, feeding))

    names = [name for name, _ in topology.data_types()]
    if feeding is None:
        feeding = {name: i for i, name in enumerate(names)}
    seq_slots = [(name, feeding[name])
                 for name, itype in topology.data_types()
                 if itype.seq_type == SEQ_SINGLE]

    def batch_key(batch):
        rows = len(batch)
        pads = []
        for name, col in seq_slots:
            if isinstance(batch, bucketing.BucketBatch):
                pads.append((name, int(batch.bucket)))
            else:
                longest = max(len(sample[col]) for sample in batch)
                pads.append((name, int(bucket_length(longest))))
        return rows, tuple(pads)

    keys = [batch_key(b) for b in reader()]
    k = int(steps_per_call or 0)
    entries = set()
    if k > 1:
        for key, steps in _chunk_plan(keys, k):
            entries.add(("scan", key, steps) if steps > 1
                        else ("step", key, 1))
    else:
        for key in keys:
            entries.add(("step", key, 1))

    out = []
    peak = 0
    for kind, (rows, pads), steps in sorted(entries):
        entry = {"kind": kind, "rows": rows, "seq_pad": dict(pads)}
        if kind == "scan":
            entry["steps"] = steps
        entry["hbm"] = estimate_hbm_bytes(
            topology, rows=rows, seq_pad=dict(pads),
            parameters=parameters, optimizer=optimizer, mode="train",
            steps=steps)
        peak = max(peak, entry["hbm"]["total"])
        out.append(entry)
    return {"entries": out, "programs": len(out), "hbm_peak_bytes": peak}


# -- reporting / trainer hook ------------------------------------------------

def format_report(report):
    lines = []
    packing = report.get("packing")
    if packing is not None:
        if packing["packed_legal"]:
            lines.append("packing: legal (no cross-position layers)")
        elif packing["rejecting_layers"]:
            lines.append("packing: rejected by %s" % ", ".join(
                "%s(%s)" % (r["layer"], r["type"])
                for r in packing["rejecting_layers"]))
        else:
            lines.append("packing: n/a (no sequence feeds)")
    donation = report.get("donation")
    if donation is not None:
        lines.append(
            "donation: trainable=%d static=%d state=%d replica=%s%s"
            % (donation["trainable"], donation["static"],
               donation["state"], donation["replica"],
               " steps_per_call=%d" % donation["steps_per_call"]
               if "steps_per_call" in donation else ""))
    hbm = report.get("hbm")
    if hbm is not None:
        lines.append(
            "hbm estimate: params=%s opt_slots=%s replica=%s resident=%s"
            % (_fmt_bytes(hbm["params"]), _fmt_bytes(hbm["opt_slots"]),
               _fmt_bytes(hbm["replica"]), _fmt_bytes(hbm["resident"])))
    for w in report.get("warnings", ()):
        lines.append("warning: " + w)
    for e in report.get("errors", ()):
        lines.append("ERROR: " + e)
    return "\n".join(lines)


def pretrain_check(trainer, steps_per_call=None):
    """The ``PADDLE_TPU_TORCH_ANALYZE=1`` hook (trainer.SGD.train): the
    static checks on a trainer's topology before the first dispatch.
    Warnings log; errors raise (they mean corruption at run time, not
    style). With ``PADDLE_TPU_TORCH_HBM_BUDGET`` set, the parameter-side
    footprint (masters + replica + optimizer slots) is checked against
    it and warns when over. It reads the trainer and changes nothing."""
    from paddle_tpu_torch.utils.logger import logger

    report = check_topology(trainer.topology,
                            parameters=trainer.parameters,
                            steps_per_call=steps_per_call)
    report["hbm"] = estimate_hbm_bytes(
        trainer.topology, parameters=trainer.parameters,
        optimizer=trainer.optimizer, mode="train")
    budget = hbm_budget_bytes()
    if budget is not None and report["hbm"]["resident"] > budget:
        report["warnings"].append(
            "static HBM estimate %s (params+replica+optimizer slots, "
            "before feeds/activations) exceeds %s=%s — shard the model or "
            "lower the budgeted batch"
            % (_fmt_bytes(report["hbm"]["resident"]), BUDGET_ENV,
               _fmt_bytes(budget)))
    for warning in report["warnings"]:
        logger.warning("analyze: %s", warning)
    if report["errors"]:
        raise ValueError("topology check failed:\n  "
                         + "\n  ".join(report["errors"]))
    return report
