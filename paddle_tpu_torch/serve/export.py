"""Export side of the port's model bundle (paddle_tpu/serve/export.py).

``export_bundle`` traces the inference forward over ``output_layer`` with
``torch.export`` once per batch bucket and writes a self-contained bundle
directory:

* ``manifest.json`` -- the JAX bundle's keys: input/output specs, the
  batch buckets and their artifacts, seq_len, framework versions, the
  platforms the programs serve on and the compute dtype they run in.
* ``params.npz`` -- the packed parameter payload, the only one: the
  programs take the parameters as their first argument, as the JAX
  package's ``forward(params, flat)`` does, so no weight is stored in a
  program.
* ``fwd_b{B}.pt2`` -- one ``torch.export.save`` program per bucket, and
  with ``decode_slots`` one ``step_s{S}.pt2`` per slot capacity.

The kernels of the served path appear in the programs as the registered
ops ``torch.ops.paddle_tpu_torch.{lstm_seq_fwd, gru_seq_fwd,
conv2d_same_fwd, int8_matmul}``; the load side (serve/bundle.py) runs the
programs without importing the graph, the layers or the models. The mixed
precision policy in force at export is traced into the programs, and the
manifest's ``compute_dtype`` records it: a bundle computes in the
export's dtype whatever policy the serving process has.

One program serves every platform it lists: factory calls record the
tracing device, and the load side moves the program to its own device
(``torch.export.passes.move_to_device_pass``). ``platforms`` names torch
device types; it defaults to the type of the parameters' device (the card
unless they were made on the CPU), and naming ``"cuda"`` on a machine
without a card raises.

``quantize="int8"`` stores the matmul/conv weights as per-output-channel
int8 with float32 scale sidecars (serve/quantize.py) in ``params.npz``;
the programs dequantize inside (``dequant_for_forward``, traced), and
``fc`` runs its int8 weight through the ``int8_matmul`` op. The
manifest's ``hbm_estimate_bytes`` is the JAX analyzer's static estimate of
the largest bucket's program (analyze/topology_check.py): the replica
fleets size ``--replicas auto`` against it.
"""

import json
import os
import time

import torch

from paddle_tpu_torch.data_type import (DENSE, INDEX, SEQ_NONE, SEQ_SINGLE,
                                        SPARSE_BINARY, SPARSE_FLOAT)
from paddle_tpu_torch.serve.bundle import (BUNDLE_FORMAT, MANIFEST_NAME,
                                           PLATFORMS, SEQ_KINDS, Bundle,
                                           sorted_dict)
from paddle_tpu_torch.serve.quantize import (dequant_for_forward,
                                             quantize_parameters)
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger

DEFAULT_BATCH_SIZES = (1, 8, 32)
DEFAULT_SEQ_LEN = 64
DEFAULT_DECODE_WINDOW = 8

# Layer types that mix values across time positions, so a decode window
# cannot reproduce the full-sequence forward: the JAX package derives the
# set from its layer sources (paddle_tpu/analyze/topology_check.py
# packed_rejecting_node_types); this is that set restricted to the layer
# types the port builds (tests/test_torch_scheduler.py holds the two
# equal).
STREAM_BLOCKED_TYPES = frozenset({
    "context_projection", "crf", "crf_decoding", "ctc", "expand",
    "first_seq", "last_seq", "pooling", "recurrent_group", "row_conv",
    "seq_concat", "seq_reshape", "seq_slice", "sub_seq"})

_KINDS = {(SEQ_NONE, DENSE): ("dense", "float32"),
          (SEQ_NONE, INDEX): ("index", "int32"),
          (SEQ_SINGLE, INDEX): ("seq_index", "int32"),
          (SEQ_SINGLE, DENSE): ("seq_dense", "float32")}


def _input_specs(topology):
    """Manifest input specs from the topology's data layers. A sparse slot
    below the ``sparse_feed_threshold`` flag feeds as densified [B, dim]
    rows (the boundary convert_feed uses), so it exports as ``dense``; at
    or above it, and in a sequence, it is refused, with the JAX package's
    messages (paddle_tpu/serve/export.py:49-84)."""
    from paddle_tpu_torch.utils import flags

    specs = []
    for name, itype in topology.data_types():
        if itype.value_type in (SPARSE_BINARY, SPARSE_FLOAT):
            enforce(itype.seq_type == SEQ_NONE, "input %r: sparse sequence "
                    "slots are not exportable", name)
            enforce(
                itype.dim < flags.get_flag("sparse_feed_threshold"),
                "input %r: sparse slots at/above sparse_feed_threshold "
                "(dim %d) feed as SparseRows, which has no fixed "
                "exportable shape; densify or lower the threshold",
                name, itype.dim)
            specs.append({"name": name, "kind": "dense", "dim": itype.dim,
                          "dtype": "float32"})
            continue
        kind = _KINDS.get((itype.seq_type, itype.value_type))
        enforce(kind is not None, "input %r: type %r is not exportable yet",
                name, itype)
        specs.append({"name": name, "kind": kind[0], "dim": itype.dim,
                      "dtype": kind[1]})
    return specs


def _check_streamable(topology, specs):
    """A topology streams through the decode step only when nothing mixes
    information across time positions except resettable recurrent
    carries, and every input is a sequence the scheduler can slice window
    by window (paddle_tpu/serve/export.py ``_check_streamable``, with the
    JAX package's messages). Reverse recurrent layers refuse when the
    step runs (layer/recurrent.py ``_run_seq_scan``)."""
    for node in topology.nodes:
        enforce(
            node.layer_type not in STREAM_BLOCKED_TYPES,
            "topology is not streamable: layer %r (type %s) mixes "
            "values across time positions, so a decode window cannot "
            "reproduce the full-sequence forward; continuous batching "
            "needs a per-position head over resettable recurrent layers",
            node.name, node.layer_type)
    for spec in specs:
        enforce(
            spec["kind"] in SEQ_KINDS,
            "decode export needs every input to be a sequence slot "
            "(got %r for input %r): non-sequence inputs have no "
            "per-timestep slice to stream", spec["kind"], spec["name"])


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn``'s arguments are the
    program's."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _make_forward(topology, specs, out_names, quantization=None):
    """The traced function: ``(params, flat) -> {output_name: tensor}``
    (paddle_tpu/serve/export.py ``_make_forward``). Sequence batches are
    rebuilt from the flat ids + lengths pairs; test-mode forward. With
    ``quantization`` the non-native int8 weights dequantize inside the
    program."""
    from paddle_tpu_torch.core.sequence import SequenceBatch

    def forward(params, flat):
        if quantization is not None:
            params = dequant_for_forward(params, quantization)
        feed = {}
        for spec in specs:
            if spec["kind"] in SEQ_KINDS:
                feed[spec["name"]] = SequenceBatch(
                    flat[spec["name"]], flat[spec["name"] + ":lens"])
            else:
                feed[spec["name"]] = flat[spec["name"]]
        values, _ = topology.apply(params, feed, mode="test")
        return {name: (values[name].data
                       if isinstance(values[name], SequenceBatch)
                       else values[name])
                for name in out_names}

    return forward


def _make_decode_step(topology, specs, out_names, quantization=None):
    """The continuous-batching decode step over a fixed ``[slots,
    window]`` matrix (paddle_tpu/serve/export.py ``_make_decode_step``):
    ``step(params, carry, flat) -> (carry', outputs)``.

    ``flat`` holds one data window per sequence input ([S, W] ids or [S,
    W, dim] rows) and two control vectors: ``lens`` [S] int32, the valid
    steps of each slot this window (0: an idle slot, its carry passes
    through under the mask), and ``reset`` [S] float32, 1 where a freshly
    admitted sequence must not see the retired occupant's carry: the
    carry is zeroed BEFORE the cells run. ``carry`` is ``{recurrent_layer:
    [leaf, ...]}`` with the slot dimension leading on every leaf. The step
    returns new carry tensors and never writes the caller's, so the
    caller rebinds, as JAX's donated step makes it."""
    from paddle_tpu_torch.core.sequence import SequenceBatch

    def step(params, carry, flat):
        if quantization is not None:
            params = dequant_for_forward(params, quantization)
        keep = 1.0 - flat["reset"]
        carry = {layer: [leaf * keep.reshape(
                             (-1,) + (1,) * (leaf.dim() - 1))
                         .to(leaf.dtype) for leaf in leaves]
                 for layer, leaves in carry.items()}
        feed = {spec["name"]: SequenceBatch(flat[spec["name"]], flat["lens"])
                for spec in specs}
        values, state_out = topology.apply_decode(params, feed, carry)
        outs = {}
        for name in out_names:
            val = values[name]
            enforce(isinstance(val, SequenceBatch),
                    "decode output %r is not a per-timestep sequence; "
                    "continuous decode emits one output row per "
                    "timestep (take the head's sequence output, not a "
                    "pooled value)", name)
            outs[name] = val.data
        return state_out, outs

    return step


def _export(fn, args):
    """``torch.export`` of ``fn`` at ``args`` (no gradient, parameters as
    arguments), without the example inputs, which would store the
    parameters in the program. Every dict argument is taken in sorted key
    order, the order ``Bundle`` passes them in (a program matches its
    inputs by position)."""
    args = tuple(sorted_dict(a) for a in args)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), args, strict=False)
    program.example_inputs = None
    return program


def _traced_outputs(program):
    """The program's outputs as its traced (fake) tensors, in the
    function's own structure: what JAX reads from ``out_avals``."""
    import torch.utils._pytree as pytree

    node = next(n for n in program.graph.nodes if n.op == "output")
    values = [arg.meta["val"] for arg in node.args[0]]
    return pytree.tree_unflatten(values, program.call_spec.out_spec)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _save(program, out_dir, artifact):
    """Write ``program``; returns the seconds the write took."""
    t0 = time.perf_counter()
    torch.export.save(program, os.path.join(out_dir, artifact))
    return time.perf_counter() - t0


def _platforms(platforms, params_device):
    """The torch device types the bundle serves on (default: that of the
    parameters' device, which is the card unless the caller made them on
    the CPU) and the device the programs are traced on (the parameters'
    where it is listed)."""
    names = ([params_device.type] if platforms is None
             else [str(p) for p in platforms])
    enforce(bool(names) and set(names) <= set(PLATFORMS),
            "platforms must name torch device types among %s, got %r",
            list(PLATFORMS), platforms)
    enforce("cuda" not in names or torch.cuda.is_available(),
            "export_bundle(platforms=%r): platform 'cuda' needs a CUDA "
            "card and torch.cuda.is_available() is false", names)
    names = sorted(set(names), key=PLATFORMS.index)
    if params_device.type in names:
        return names, params_device
    return names, torch.device(names[0])


def _check_declared(params, topology, quantization):
    """Every parameter the topology declares is in ``params`` with its
    declared shape (the JAX package passes the trainer's whole set, so
    names the served forward never reads, a CRF's transitions, may ride
    along)."""
    qinfo = (quantization or {}).get("params", {})
    for name, spec in topology.param_specs().items():
        enforce(name in params, "parameter %r of the topology is missing",
                name)
        enforce(tuple(params[name].shape) == tuple(spec.shape),
                "parameter %r: shape %s, the topology declares %s", name,
                tuple(params[name].shape), tuple(spec.shape))
        if name in qinfo:
            enforce(qinfo[name]["scale"] in params,
                    "quantized parameter %r has no scale sidecar", name)


# seconds of the last ``export_bundle``: {artifact: {"export_s": tracing,
# "save_s": writing}}
last_export_seconds = {}


def export_bundle(output_layer, parameters, out_dir,
                  batch_sizes=DEFAULT_BATCH_SIZES, seq_len=None, name=None,
                  platforms=None, decode_slots=None, decode_window=None,
                  quantize=None):
    """Export the inference forward over ``output_layer`` (a layer or a
    list of them) as a bundle directory; returns the manifest dict
    (paddle_tpu/serve/export.py ``export_bundle``, the same signature).

    ``parameters`` is a :class:`Parameters` holding at least the
    topology's parameters (a trainer's whole set may ride along).
    ``batch_sizes`` are the exported batch buckets (the engine pads each
    dynamic batch up to the nearest one); ``seq_len`` fixes the padded
    time dimension of sequence inputs (default 64). ``platforms``: see
    the module docstring. ``decode_slots`` (slot capacities) adds one
    continuous-batching decode-step program per capacity for a streamable
    topology, with ``decode_window`` timesteps per dispatch (default
    ``DEFAULT_DECODE_WINDOW`` = 8). ``quantize`` ("int8" or None)
    quantizes the payload's matmul/conv weights."""
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.graph import LayerNode
    from paddle_tpu_torch.topology import Topology

    outputs = ([output_layer] if isinstance(output_layer, LayerNode)
               else list(output_layer))
    topology = Topology(outputs)
    out_names = [o.name for o in outputs]
    specs = _input_specs(topology)
    enforce(bool(specs), "topology has no data layers to feed")
    batch_sizes = sorted({int(b) for b in batch_sizes})
    enforce(bool(batch_sizes) and batch_sizes[0] >= 1,
            "batch_sizes must be positive, got %r", batch_sizes)
    has_seq = any(s["kind"] in SEQ_KINDS for s in specs)
    seq_len = int(seq_len or DEFAULT_SEQ_LEN) if has_seq else None
    values = parameters.as_dict()
    platform_names, device = _platforms(
        platforms, next(iter(values.values())).device if values
        else torch.device("cpu"))
    quantization = None
    if quantize:
        enforce(quantize == "int8",
                "unsupported quantize scheme %r (only 'int8')", quantize)
        # the quantized Parameters replace the fp payload from here on
        parameters, quantization = quantize_parameters(parameters, topology)
    params = {k: v.detach().to(device)
              for k, v in parameters.as_dict().items()}
    _check_declared(params, topology, quantization)

    os.makedirs(out_dir, exist_ok=True)
    last_export_seconds.clear()
    forward = _make_forward(topology, specs, out_names, quantization)
    buckets, out_specs = [], None
    for batch in batch_sizes:
        flat = {}
        for spec in specs:
            flat[spec["name"]] = torch.zeros(
                _feed_shape(spec, batch, seq_len),
                dtype=getattr(torch, spec["dtype"]), device=device)
            if spec["kind"] in SEQ_KINDS:
                flat[spec["name"] + ":lens"] = torch.full(
                    (batch,), seq_len, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        program = _export(forward, (params, flat))
        artifact = "fwd_b%d.pt2" % batch
        last_export_seconds[artifact] = {
            "export_s": time.perf_counter() - t0,
            "save_s": _save(program, out_dir, artifact)}
        buckets.append({"batch": batch, "artifact": artifact})
        if out_specs is None:
            traced = _traced_outputs(program)
            out_specs = [{"name": n, "dtype": _dtype_name(traced[n].dtype),
                          "shape_suffix": [int(d)
                                           for d in traced[n].shape[1:]]}
                         for n in out_names]

    decode = None
    if decode_slots:
        decode = _export_decode(topology, specs, out_names, params,
                                quantization, decode_slots, decode_window,
                                device, out_dir)

    params_file = "params.npz"
    with open(os.path.join(out_dir, params_file), "wb") as fh:
        parameters.to_npz(fh)
    hbm_total = _hbm_estimate(topology, specs, parameters, batch_sizes[-1],
                              seq_len)
    from paddle_tpu_torch import __version__

    cd = dtype_mod.compute_dtype()
    manifest = {
        "format": BUNDLE_FORMAT,
        "version": 1,
        "name": name or out_names[0],
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "framework": {"paddle_tpu_torch": __version__,
                      "torch": torch.__version__},
        "platforms": platform_names,
        "compute_dtype": _dtype_name(cd) if cd is not None else "float32",
        "inputs": specs,
        "outputs": out_specs,
        "seq_len": seq_len,
        "buckets": buckets,
        "params_file": params_file,
        "hbm_estimate_bytes": hbm_total,
    }
    if quantization is not None:
        manifest["quantization"] = quantization
    if decode is not None:
        manifest["decode"] = decode
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


def _hbm_estimate(topology, specs, parameters, rows, seq_len):
    """The static device-memory estimate of the largest bucket's program
    (parameters, its feed and the forward's activations;
    analyze/topology_check.py), the manifest's ``hbm_estimate_bytes``: the
    replica fleets size against it. A bundle over the budget
    (``PADDLE_TPU_TORCH_HBM_BUDGET``) is written with a warning."""
    from paddle_tpu_torch.analyze import topology_check

    seq_pads = {s["name"]: seq_len for s in specs if s["kind"] in SEQ_KINDS}
    total = int(topology_check.estimate_hbm_bytes(
        topology, rows=rows, seq_pad=seq_pads, parameters=parameters,
        mode="infer")["total"])
    budget = topology_check.hbm_budget_bytes()
    if budget is not None and total > budget:
        logger.warning(
            "export_bundle: static device-memory estimate %s for the "
            "largest bucket (batch=%d) exceeds %s=%s; the bundle will not "
            "fit its serving card", topology_check._fmt_bytes(total), rows,
            topology_check.BUDGET_ENV, topology_check._fmt_bytes(budget))
    return total


def _export_decode(topology, specs, out_names, params, quantization,
                   decode_slots, decode_window, device, out_dir):
    """One decode-step program per slot capacity; returns the manifest's
    ``decode`` block (window, slot entries, the carry spec). The carry
    spec comes from the traced outputs of the step run without a carry
    (every recurrent layer boots from zeros), as JAX's comes from
    ``eval_shape`` of its probe."""
    _check_streamable(topology, specs)
    window = int(decode_window or DEFAULT_DECODE_WINDOW)
    enforce(window >= 1, "decode_window must be >= 1, got %r", window)
    slot_sizes = sorted({int(s) for s in decode_slots})
    enforce(slot_sizes[0] >= 1, "decode_slots must be positive, got %r",
            decode_slots)
    step = _make_decode_step(topology, specs, out_names, quantization)
    carry_spec, slots_out = None, []
    for slots in slot_sizes:
        flat = {"lens": torch.full((slots,), window, dtype=torch.int32,
                                   device=device),
                "reset": torch.zeros((slots,), dtype=torch.float32,
                                     device=device)}
        for spec in specs:
            shape = ((slots, window) if spec["kind"] == "seq_index"
                     else (slots, window, spec["dim"]))
            flat[spec["name"]] = torch.zeros(
                shape, dtype=getattr(torch, spec["dtype"]), device=device)
        if carry_spec is None:
            state = _traced_outputs(_export(step, (params, {}, flat)))[0]
            enforce(bool(state),
                    "decode export found no recurrent carries — a "
                    "carry-free topology has nothing to stream; serve it "
                    "through the ordinary batch buckets")
            carry_spec = {layer: [{"shape_suffix": [int(d)
                                                    for d in leaf.shape[1:]],
                                   "dtype": _dtype_name(leaf.dtype)}
                                  for leaf in leaves]
                          for layer, leaves in state.items()}
        carry = {layer: [torch.zeros((slots,) + tuple(leaf["shape_suffix"]),
                                     dtype=getattr(torch, leaf["dtype"]),
                                     device=device) for leaf in leaves]
                 for layer, leaves in carry_spec.items()}
        t0 = time.perf_counter()
        program = _export(step, (params, carry, flat))
        artifact = "step_s%d.pt2" % slots
        last_export_seconds[artifact] = {
            "export_s": time.perf_counter() - t0,
            "save_s": _save(program, out_dir, artifact)}
        slots_out.append({"slots": slots, "artifact": artifact})
    return {"window": window, "slots": slots_out, "carry": carry_spec}


def _feed_shape(spec, batch, seq_len):
    kind = spec["kind"]
    if kind == "dense":
        return (batch, spec["dim"])
    if kind == "index":
        return (batch,)
    if kind == "seq_index":
        return (batch, seq_len)
    if kind == "seq_dense":
        return (batch, seq_len, spec["dim"])
    raise ValueError("unknown input kind %r" % kind)


def verify_bundle(out_dir, device=None):
    """Reload the just-written bundle in this process on ``device`` (the
    default device) and run its smallest bucket on dummy inputs, and one
    decode window of a decode bundle: the export-time smoke that the
    programs load and run (paddle_tpu/serve/export.py ``verify_bundle``).
    Returns ``{output: shape}``."""
    import numpy as np

    bundle = Bundle(out_dir, device=device)
    out = bundle.infer(bundle.dummy_inputs(1))
    for name, arr in out.items():
        enforce(np.all(np.isfinite(arr)),
                "bundle selfcheck: output %r is not finite", name)
    if bundle.has_decoder():
        bundle.warmup_decoder()
    return {k: v.shape for k, v in out.items()}
