"""Load side of the port's model bundle (paddle_tpu/serve/bundle.py).

A bundle directory holds ``manifest.json`` and ``params.npz``. The
manifest keeps the JAX bundle's keys (``inputs``, ``outputs``,
``seq_len``, ``buckets``, ``params_file``) and adds a ``builder`` entry
(module, function, kwargs): in this first part of the port the load side
rebuilds the topology by calling that builder, then copies ``params.npz``
onto the device through ``convert.params_from_numpy``, which checks every
name and shape. (A deserialisation-only artifact, ``torch.export`` with
the kernels registered as custom ops, is queued in ROADMAP.md.)

A quantized bundle (``export_bundle(quantize="int8")``) keeps its int8
tensors int8 and its scale sidecars float32 on the device; every forward
of ``run`` dequantizes the conv weights for that forward
(``quantize.dequant_for_forward``), and ``fc`` runs its int8 weight in the
dequant-fused kernel.

A bundle exported with ``decode_slots`` also runs the continuous-batching
decode step (serve/export.py ``_make_decode_step``) for the scheduler
(serve/scheduler.py): ``zero_carry``, ``decode_step``, and the session
tier's ``carry_slice`` / ``carry_insert``. The step runs eagerly, one
kernel launch per recurrent layer a window; its shapes are the slot
capacity and the window, so admission and retirement change tensor values
only.
"""

import importlib
import json
import os
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data.bucketing import bucket_index
from paddle_tpu_torch.serve.quantize import dequant_for_forward

MANIFEST_NAME = "manifest.json"
BUNDLE_FORMAT = "paddle_tpu_torch-bundle-v1"

# input kinds (manifest "kind") -> flat feed keys:
#   dense      f32 [B, dim]                      keys: [name]
#   index      i32 [B]                           keys: [name]
#   seq_index  i32 [B, T] ids + i32 [B] lengths  keys: [name, name+":lens"]
#   seq_dense  f32 [B, T, dim] + i32 [B] lengths keys: [name, name+":lens"]
SEQ_KINDS = ("seq_index", "seq_dense")


def flat_keys(spec):
    """Flat feed keys of one manifest input spec, in feed order."""
    if spec["kind"] in SEQ_KINDS:
        return [spec["name"], spec["name"] + ":lens"]
    return [spec["name"]]


def build_outputs(builder):
    """Call a manifest ``builder`` entry: the output layer(s) it returns,
    built with fresh name counters so layer names match the export."""
    from paddle_tpu_torch.graph import reset_name_counters

    fn = getattr(importlib.import_module(builder["module"]),
                 builder["function"])
    reset_name_counters()
    return fn(**builder.get("kwargs", {}))


class Bundle:
    """A loaded bundle: manifest, the rebuilt topology, and its parameters
    resident on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, directory, device=None):
        from paddle_tpu_torch.convert import params_from_numpy
        from paddle_tpu_torch.topology import Topology

        self.directory = os.path.abspath(directory)
        self.device = resolve_device(device)
        with open(os.path.join(self.directory, MANIFEST_NAME)) as fh:
            self.manifest = json.load(fh)
        if self.manifest.get("format") != BUNDLE_FORMAT:
            raise ValueError("%s is not a %s bundle (format=%r)"
                             % (directory, BUNDLE_FORMAT,
                                self.manifest.get("format")))
        self.name = self.manifest.get("name", "model")
        self.inputs = self.manifest["inputs"]
        self.outputs = self.manifest["outputs"]
        self.seq_len = self.manifest.get("seq_len")
        # the quantization block of a quantized bundle (serve/quantize.py)
        self.quantization = self.manifest.get("quantization")
        self.buckets = sorted(self.manifest["buckets"],
                              key=lambda b: b["batch"])
        if not self.buckets:
            raise ValueError("bundle %s has no batch buckets" % directory)
        outputs = build_outputs(self.manifest["builder"])
        self.topology = Topology(outputs)
        self._out_names = [o["name"] for o in self.outputs]
        with np.load(os.path.join(self.directory,
                                  self.manifest["params_file"])) as pz:
            arrays = {k: pz[k] for k in pz.files}
        self.params = params_from_numpy(arrays, self.topology, self.device,
                                        quantization=self.quantization)
        # the engine's async warmup thread and its batcher worker may both
        # run a forward; one at a time keeps the device work ordered
        self._run_lock = threading.Lock()
        self._decode_step = None

    # -- bucket/shape machinery ---------------------------------------------
    def batch_sizes(self):
        return [b["batch"] for b in self.buckets]

    def max_batch(self):
        return self.buckets[-1]["batch"]

    def bucket_for(self, rows):
        """The smallest exported bucket holding ``rows`` rows."""
        try:
            return self.buckets[bucket_index(rows, self.batch_sizes())]
        except ValueError:
            raise ValueError(
                "batch of %d rows exceeds the largest exported bucket (%d); "
                "re-export with a larger batch size or split the request"
                % (rows, self.max_batch())) from None

    def feed_shape(self, spec, batch):
        kind = spec["kind"]
        if kind == "dense":
            return (batch, spec["dim"])
        if kind == "index":
            return (batch,)
        if kind == "seq_index":
            return (batch, self.seq_len)
        if kind == "seq_dense":
            return (batch, self.seq_len, spec["dim"])
        raise ValueError("unknown input kind %r" % kind)

    def dummy_inputs(self, rows=1):
        """Zero-valued flat inputs for ``rows`` rows (warmup/selfcheck)."""
        out = {}
        for spec in self.inputs:
            out[spec["name"]] = np.zeros(self.feed_shape(spec, rows),
                                         np.dtype(spec["dtype"]))
            if spec["kind"] in SEQ_KINDS:
                out[spec["name"] + ":lens"] = np.full((rows,), self.seq_len,
                                                      np.int32)
        return out

    def validate_inputs(self, flat_inputs):
        """Out-of-range sequence lengths would silently ride the mask and
        return plausible garbage: refuse them."""
        for spec in self.inputs:
            if spec["kind"] not in SEQ_KINDS:
                continue
            key = spec["name"] + ":lens"
            if key not in flat_inputs:
                continue
            lens = np.asarray(flat_inputs[key])
            if lens.size and (lens.min() < 0 or lens.max() > self.seq_len):
                raise ValueError(
                    "input %r: sequence lengths must be in [0, seq_len=%d], "
                    "got [%d, %d]" % (spec["name"], self.seq_len,
                                      int(lens.min()), int(lens.max())))

    # -- execution ----------------------------------------------------------
    def _feed(self, flat_inputs):
        feed = {}
        for spec in self.inputs:
            data = torch.as_tensor(np.asarray(flat_inputs[spec["name"]]),
                                   device=self.device)
            if spec["kind"] in SEQ_KINDS:
                lens = torch.as_tensor(
                    np.asarray(flat_inputs[spec["name"] + ":lens"],
                               dtype=np.int32), device=self.device)
                feed[spec["name"]] = SequenceBatch(data, lens)
            else:
                feed[spec["name"]] = data
        return feed

    def run(self, flat_inputs, batch):
        """Run one exact-bucket batch (no padding logic). Returns
        ``{output_name: np.ndarray}``."""
        for key, arr in flat_inputs.items():
            if np.shape(arr)[0] != batch:
                raise ValueError("input %r has %d rows, bucket is %d"
                                 % (key, np.shape(arr)[0], batch))
        with self._run_lock:
            params = self.params
            if self.quantization:
                params = dequant_for_forward(params, self.quantization)
            values = self.topology.apply(params, self._feed(flat_inputs),
                                         mode="test")
            out = {}
            for name in self._out_names:
                val = values[name]
                val = val.data if isinstance(val, SequenceBatch) else val
                out[name] = val.float().cpu().numpy()
        return out

    def warmup(self):
        """Run every bucket once on dummy inputs (the kernels build and the
        allocator reaches its steady state before traffic). Returns the
        number of buckets run."""
        for bucket in self.buckets:
            self.run(self.dummy_inputs(bucket["batch"]), bucket["batch"])
        return len(self.buckets)

    # -- continuous-batching decode side ------------------------------------
    def has_decoder(self):
        """True when the bundle was exported with ``decode_slots``."""
        return bool(self.manifest.get("decode"))

    @property
    def decode_window(self):
        """Timesteps per decode dispatch (None without a decoder)."""
        dec = self.manifest.get("decode")
        return int(dec["window"]) if dec else None

    def decode_slot_sizes(self):
        dec = self.manifest.get("decode") or {"slots": []}
        return sorted(int(b["slots"]) for b in dec["slots"])

    def _decode_bucket(self, slots=None):
        dec = self.manifest.get("decode")
        if not dec:
            raise ValueError(
                "bundle %s has no decode artifacts; re-export with "
                "decode_slots= for continuous batching" % self.name)
        buckets = sorted(dec["slots"], key=lambda b: int(b["slots"]))
        if slots is None:
            return buckets[-1]
        for b in buckets:
            if int(b["slots"]) == int(slots):
                return b
        raise ValueError(
            "no decode artifact for slot capacity %r (exported: %s)"
            % (slots, [int(b["slots"]) for b in buckets]))

    def _decode_fn(self):
        """The decode step over the rebuilt topology (built once)."""
        if self._decode_step is None:
            from paddle_tpu_torch.serve.export import _make_decode_step

            specs = [s for s in self.inputs if s["kind"] in SEQ_KINDS]
            self._decode_step = _make_decode_step(
                self.topology, specs, self._out_names, self.quantization)
        return self._decode_step

    def zero_carry(self, slots=None, device=None):
        """The virgin recurrent carry for one slot capacity,
        ``{recurrent_layer: [zeros [slots, ...], ...]}`` per the manifest's
        carry spec, on ``device`` (default: the bundle's)."""
        slots = int(self._decode_bucket(slots)["slots"])
        device = self.device if device is None else torch.device(device)
        return {layer: [torch.zeros((slots,) + tuple(leaf["shape_suffix"]),
                                    dtype=getattr(torch, leaf["dtype"]),
                                    device=device)
                        for leaf in leaves]
                for layer, leaves in self.manifest["decode"]["carry"].items()}

    def decode_step(self, carry, flat, slots=None):
        """Run ONE decode window: ``(carry, flat) -> (carry', outputs)``.
        ``flat`` is ``dummy_decode_flat``'s dict (numpy or tensors); the
        new carry and the [slots, window, ...] outputs stay on the device
        (the scheduler's one readback a window is its own). The step
        returns new carry tensors and never writes ``carry``: callers
        rebind (``carry, outs = bundle.decode_step(carry, ...)``)."""
        slots = int(self._decode_bucket(slots)["slots"])
        lens = flat["lens"]
        if np.shape(lens) != (slots,):
            raise ValueError("decode step for %d slots got lens of shape %s"
                             % (slots, np.shape(lens)))
        feed = {k: torch.as_tensor(v, device=self.device)
                for k, v in flat.items()}
        with self._run_lock:
            return self._decode_fn()(self.params, carry, feed)

    def carry_slice(self, carry, index):
        """One slot's carry rows as fresh device copies, ``{layer: [row,
        ...]}`` with the slot dimension sliced off: the spill extraction of
        the session tier, enqueued on the current stream, so a later
        window's step cannot overwrite what it reads."""
        with torch.inference_mode():
            return {layer: [leaf[int(index)].clone() for leaf in leaves]
                    for layer, leaves in carry.items()}

    def carry_insert(self, carry, rows, index):
        """Write one session's (host) carry rows into slot ``index``: the
        reset=0 restore path. Returns the new carry; callers rebind
        (``carry = bundle.carry_insert(carry, ...)``), as with the step."""
        out = {}
        with torch.inference_mode():
            for layer, leaves in carry.items():
                new = []
                for leaf, row in zip(leaves, rows[layer]):
                    leaf = leaf.clone()
                    # a copy: a store's rows may be read-only arrays
                    leaf[int(index)] = torch.as_tensor(
                        row if torch.is_tensor(row) else np.array(row),
                        dtype=leaf.dtype, device=leaf.device)
                    new.append(leaf)
                out[layer] = new
        return out

    def dummy_decode_flat(self, slots=None, window=None):
        """Zero-valued decode-step inputs (numpy): ``lens`` and ``reset``
        [slots] and one [slots, window(, dim)] window per sequence
        input."""
        slots = int(self._decode_bucket(slots)["slots"])
        window = int(window or self.decode_window)
        flat = {"lens": np.zeros((slots,), np.int32),
                "reset": np.zeros((slots,), np.float32)}
        for spec in self.inputs:
            shape = ((slots, window) if spec["kind"] == "seq_index"
                     else (slots, window, spec["dim"]))
            flat[spec["name"]] = np.zeros(shape, np.dtype(spec["dtype"]))
        return flat

    def warmup_decoder(self, slots=None):
        """Run the decode step twice (a fresh carry, then the carry it
        returned) and one slice/insert round trip, as the JAX package's
        warmup does: the kernel libraries load and the allocator reaches
        its steady state before traffic, so paging churn after it builds
        and loads nothing. Returns the slot capacity."""
        slot_count = int(self._decode_bucket(slots)["slots"])
        carry = self.zero_carry(slot_count)
        for _ in range(2):
            carry, _ = self.decode_step(
                carry, self.dummy_decode_flat(slot_count), slot_count)
        rows = self.carry_slice(carry, 0)
        host = {layer: [leaf.cpu().numpy() for leaf in leaves]
                for layer, leaves in rows.items()}
        self.carry_insert(carry, host, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return slot_count

    def infer(self, flat_inputs, rows=None):
        """Pad ``flat_inputs`` to the nearest bucket, run, slice the
        padding back off."""
        first = next(iter(flat_inputs.values()))
        rows = int(np.shape(first)[0]) if rows is None else int(rows)
        if rows < 1:
            raise ValueError("cannot infer an empty batch (rows=%d)" % rows)
        self.validate_inputs(flat_inputs)
        bucket = self.bucket_for(rows)
        padded = {k: pad_rows(np.asarray(v), bucket["batch"])
                  for k, v in flat_inputs.items()}
        out = self.run(padded, bucket["batch"])
        return {k: arr[:rows] for k, arr in out.items()}

    def __repr__(self):
        quant = (", quantized=%s" % self.quantization["scheme"]
                 if self.quantization else "")
        return "Bundle(%r, buckets=%s, inputs=%s, device=%s%s)" % (
            self.name, self.batch_sizes(), [i["name"] for i in self.inputs],
            self.device, quant)


def pad_rows(arr, to_rows):
    """Pad a batch array to ``to_rows`` rows by replicating the last row —
    replicated rows are valid model inputs for every input kind, and the
    padding is sliced off after the forward."""
    n = arr.shape[0]
    if n == to_rows:
        return arr
    if n == 0:
        raise ValueError("cannot pad an empty batch (no row to replicate)")
    if n > to_rows:
        raise ValueError("cannot pad %d rows down to %d" % (n, to_rows))
    return np.concatenate([arr, np.repeat(arr[-1:], to_rows - n, axis=0)],
                          axis=0)


def load_bundle(directory, device=None):
    """Load a port bundle directory onto ``device`` (the card by default)."""
    return Bundle(directory, device=device)
