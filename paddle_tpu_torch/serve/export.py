"""Export side of the port's model bundle (paddle_tpu/serve/export.py).

``export_bundle`` writes ``manifest.json`` (input/output specs, batch
buckets, seq_len, framework versions and the ``builder`` entry the load
side rebuilds the topology from) and ``params.npz``, the same packed
payload the JAX package writes. Nothing runs on the card: the parameter
names and shapes are checked against the rebuilt topology, and the output
specs come from the output layers' widths (``[seq_len, size]`` per row for
a sequence output, ``[size]`` otherwise; float32, the compute dtype).

``decode_slots`` adds the manifest's ``decode`` block (window, one entry
per slot capacity, the carry spec) for the continuous-batching decode step
of a streamable topology (``_check_streamable``); the load side builds the
step (``_make_decode_step``) from the rebuilt topology, as it does the
forward, and the carry spec comes from one probe run of the step on the
CPU. The port writes no AOT artifact, so a slot entry names no file.

``quantize="int8"`` stores the matmul/conv weights as per-output-channel
int8 with float32 scale sidecars (serve/quantize.py) in ``params.npz`` and
records the scheme in ``manifest["quantization"]``. The JAX manifest's
``hbm_estimate_bytes`` is not written yet (it belongs to the fleet's
``--replicas auto``, which is not ported).
"""

import importlib
import json
import os
import time

import torch

from paddle_tpu_torch.convert import check_param_shapes
from paddle_tpu_torch.data_type import (DENSE, INDEX, SEQ_NONE, SEQ_SINGLE,
                                        SPARSE_BINARY, SPARSE_FLOAT)
from paddle_tpu_torch.serve.bundle import (BUNDLE_FORMAT, MANIFEST_NAME,
                                           SEQ_KINDS, build_outputs)
from paddle_tpu_torch.serve.quantize import (dequant_for_forward,
                                             quantize_parameters)
from paddle_tpu_torch.utils.error import enforce

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
    "context_projection", "crf", "crf_decoding", "expand", "first_seq",
    "last_seq", "pooling", "recurrent_group", "seq_concat", "seq_reshape",
    "seq_slice", "sub_seq"})

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


def is_sequence(node):
    """Whether a layer's value is a sequence batch: data layers by their
    input type, pooling never, any other layer as its inputs."""
    if node.layer_type == "data":
        return node.input_type.seq_type != SEQ_NONE
    if node.layer_type == "pooling":
        return False
    return any(is_sequence(parent) for parent in node.inputs)


def output_specs(topology, seq_len):
    """Manifest output specs: name, dtype and per-row shape."""
    return [{"name": o.name, "dtype": "float32",
             "shape_suffix": ([seq_len, o.size] if is_sequence(o)
                              else [o.size])}
            for o in topology.outputs]


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
    is functional: it returns new carry tensors and never writes the
    caller's, so the caller rebinds, as JAX's donated step makes it, and
    no spill can read a later window's rows. The outputs are [S, W, ...]
    tensors on the step's device. A quantized bundle dequantizes its
    non-native weights at the top of every step, as ``Bundle.run`` does."""
    from paddle_tpu_torch.core.sequence import SequenceBatch

    def step(params, carry, flat):
        with torch.inference_mode():
            if quantization is not None:
                params = dequant_for_forward(params, quantization)
            keep = 1.0 - flat["reset"]
            carry = {layer: [leaf * keep.reshape(
                                 (-1,) + (1,) * (leaf.dim() - 1))
                             .to(leaf.dtype) for leaf in leaves]
                     for layer, leaves in carry.items()}
            feed = {spec["name"]: SequenceBatch(flat[spec["name"]],
                                                flat["lens"])
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


def _decode_manifest(topology, specs, out_names, parameters, quantization,
                     decode_slots, decode_window):
    """The manifest's ``decode`` block: the window, one entry per slot
    capacity and the carry spec (``shape_suffix``, ``dtype`` per leaf),
    read from one probe run of the step on the CPU at one slot."""
    _check_streamable(topology, specs)
    window = int(decode_window or DEFAULT_DECODE_WINDOW)
    enforce(window >= 1, "decode_window must be >= 1, got %r", window)
    slot_sizes = sorted({int(s) for s in decode_slots})
    enforce(slot_sizes[0] >= 1, "decode_slots must be positive, got %r",
            decode_slots)
    params = {k: v.detach().cpu() for k, v in parameters.as_dict().items()}
    flat = {"lens": torch.full((1,), window, dtype=torch.int32),
            "reset": torch.zeros((1,), dtype=torch.float32)}
    for spec in specs:
        shape = ((1, window) if spec["kind"] == "seq_index"
                 else (1, window, spec["dim"]))
        flat[spec["name"]] = torch.zeros(
            shape, dtype=getattr(torch, spec["dtype"]))
    step = _make_decode_step(topology, specs, out_names, quantization)
    state, _ = step(params, {}, flat)
    enforce(bool(state),
            "decode export found no recurrent carries — a carry-free "
            "topology has nothing to stream; serve it through the "
            "ordinary batch buckets")
    carry = {layer: [{"shape_suffix": [int(d) for d in leaf.shape[1:]],
                      "dtype": str(leaf.dtype).replace("torch.", "")}
                     for leaf in leaves]
             for layer, leaves in state.items()}
    return {"window": window, "slots": [{"slots": s} for s in slot_sizes],
            "carry": carry}


def parse_builder(spec, kwargs=None):
    """``"module.path:function"`` (+ kwargs) -> the manifest builder entry."""
    module, _, function = spec.partition(":")
    enforce(module and function,
            "builder must be 'module.path:function', got %r", spec)
    getattr(importlib.import_module(module), function)  # fail early
    return {"module": module, "function": function,
            "kwargs": dict(kwargs or {})}


def export_bundle(builder, parameters, out_dir,
                  batch_sizes=DEFAULT_BATCH_SIZES, seq_len=None, name=None,
                  decode_slots=None, decode_window=None, quantize=None,
                  trained=False):
    """Write a bundle directory for the topology ``builder`` builds;
    returns the manifest dict.

    ``builder`` is ``"module.path:function"`` or a manifest builder entry
    (``parse_builder``); ``parameters`` a :class:`Parameters` whose names
    and shapes must match the topology. ``batch_sizes`` are the batch
    buckets the engine pads each dynamic batch up to; ``seq_len`` fixes the
    padded time dimension of sequence inputs (default 64). ``quantize``
    ("int8" or None) quantizes the weights of the payload (module
    docstring). ``decode_slots`` (slot capacities) adds the
    continuous-batching decode block for a streamable topology, with
    ``decode_window`` timesteps per dispatch (default
    ``DEFAULT_DECODE_WINDOW`` = 8). ``trained=True`` takes ``parameters`` as a
    trainer's superset and keeps the names the topology declares: a cost
    head's own (a CRF's transitions) stay behind, as the served forward
    never reads them; a declared name the superset lacks still raises."""
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    if isinstance(builder, str):
        builder = parse_builder(builder)
    topology = Topology(build_outputs(builder))
    if trained:
        declared = topology.param_specs()
        values = parameters.as_dict()
        kept = [n for n in values if n in declared]
        parameters = Parameters({n: values[n] for n in kept},
                                {n: parameters.spec(n) for n in kept})
    specs = _input_specs(topology)
    enforce(bool(specs), "topology has no data layers to feed")
    batch_sizes = sorted({int(b) for b in batch_sizes})
    enforce(bool(batch_sizes) and batch_sizes[0] >= 1,
            "batch_sizes must be positive, got %r", batch_sizes)
    has_seq = any(s["kind"] in SEQ_KINDS for s in specs)
    seq_len = int(seq_len or DEFAULT_SEQ_LEN) if has_seq else None
    quantization = None
    if quantize:
        enforce(quantize == "int8",
                "unsupported quantize scheme %r (only 'int8')", quantize)
        # the quantized Parameters replace the fp payload from here on
        parameters, quantization = quantize_parameters(parameters, topology)
    check_param_shapes({name: tuple(t.shape)
                        for name, t in parameters.as_dict().items()},
                       topology, quantization)
    out_specs = output_specs(topology, seq_len)
    decode = None
    if decode_slots:
        decode = _decode_manifest(
            topology, specs, [o["name"] for o in out_specs], parameters,
            quantization, decode_slots, decode_window)

    os.makedirs(out_dir, exist_ok=True)
    params_file = "params.npz"
    with open(os.path.join(out_dir, params_file), "wb") as fh:
        parameters.to_npz(fh)
    from paddle_tpu_torch import __version__

    manifest = {
        "format": BUNDLE_FORMAT,
        "version": 1,
        "name": name or topology.outputs[0].name,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "framework": {"paddle_tpu_torch": __version__,
                      "torch": torch.__version__},
        "compute_dtype": "float32",
        "builder": builder,
        "inputs": specs,
        "outputs": out_specs,
        "seq_len": seq_len,
        "buckets": [{"batch": b} for b in batch_sizes],
        "params_file": params_file,
    }
    if quantization is not None:
        manifest["quantization"] = quantization
    if decode is not None:
        manifest["decode"] = decode
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest
