"""Export side of the port's model bundle (paddle_tpu/serve/export.py).

``export_bundle`` writes ``manifest.json`` (input/output specs, batch
buckets, seq_len, framework versions and the ``builder`` entry the load
side rebuilds the topology from) and ``params.npz``, the same packed
payload the JAX package writes. Nothing runs on a device: the parameter
names and shapes are checked against the rebuilt topology, and the output
specs come from the output layers' widths (``[seq_len, size]`` per row for
a sequence output, ``[size]`` otherwise; float32, the compute dtype).

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
from paddle_tpu_torch.serve.quantize import quantize_parameters
from paddle_tpu_torch.utils.error import enforce

DEFAULT_BATCH_SIZES = (1, 8, 32)
DEFAULT_SEQ_LEN = 64

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
                  decode_slots=None, quantize=None, trained=False):
    """Write a bundle directory for the topology ``builder`` builds;
    returns the manifest dict.

    ``builder`` is ``"module.path:function"`` or a manifest builder entry
    (``parse_builder``); ``parameters`` a :class:`Parameters` whose names
    and shapes must match the topology. ``batch_sizes`` are the batch
    buckets the engine pads each dynamic batch up to; ``seq_len`` fixes the
    padded time dimension of sequence inputs (default 64). ``quantize``
    ("int8" or None) quantizes the weights of the payload (module
    docstring). The continuous-batching decode step (``decode_slots``) is
    not ported yet and raises. ``trained=True`` takes ``parameters`` as a
    trainer's superset and keeps the names the topology declares: a cost
    head's own (a CRF's transitions) stay behind, as the served forward
    never reads them; a declared name the superset lacks still raises."""
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    enforce(not decode_slots, "export_bundle(decode_slots=...): the "
            "continuous-batching decode step is not ported yet")

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
        "outputs": output_specs(topology, seq_len),
        "seq_len": seq_len,
        "buckets": [{"batch": b} for b in batch_sizes],
        "params_file": params_file,
    }
    if quantization is not None:
        manifest["quantization"] = quantization
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest
