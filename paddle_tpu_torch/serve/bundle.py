"""Load side of the port's model bundle (paddle_tpu/serve/bundle.py).

A bundle directory is what ``serve.export_bundle`` writes: a versioned
``manifest.json``, ``params.npz`` (the parameter payload) and one
``torch.export`` program per batch bucket (and per decode slot capacity).
:class:`Bundle` loads it by deserialization alone: it imports none of the
graph, topology, layer, network, model or config modules and never
builds a topology. ``params.npz`` goes onto the bundle's device once;
each bucket's program is deserialized at its first use, under a lock,
moved to that device (one program serves every platform the manifest
lists) and cached. The kernels inside the programs are the registered
ops of ``paddle_tpu_torch.ops`` (``_register_ops``), which launch the
hand-written kernels on the card and run their plain versions on the CPU.

The programs hold the export's compute dtype: a bundle exported under the
bfloat16 policy computes in bfloat16 whatever the serving process's
policy, and its outputs come back as float32 arrays. A quantized bundle
keeps its int8 tensors int8 on the device; its programs dequantize
inside.

A bundle exported with ``decode_slots`` also runs the continuous-batching
decode step for the scheduler (serve/scheduler.py): ``zero_carry``,
``decode_step``, and the session tier's ``carry_slice`` /
``carry_insert``; its shapes are the slot capacity and the window, so
admission and retirement change tensor values only.

Replica fleets (serve/fleet.py) serve one bundle from several engine
threads: :meth:`Bundle.view` gives each a :class:`BundleReplica` on a
device, which shares the manifest, the host payload and the deserialized
programs, holds the parameters and the programs moved to its device once
per device (``Bundle.params(device)``), and keeps its own per-call
state (the run lock; ``last_device_ms`` per calling thread). Every view
on one card shares the card's placement and its default stream, so the
views' kernels run in the order the threads enqueue them.

Bundles written before the programs existed (a manifest ``builder``
entry and no artifacts) are refused with a message to re-export them.
"""

import json
import os
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.data.bucketing import bucket_index
from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.serve.sessions import host_leaf

MANIFEST_NAME = "manifest.json"
BUNDLE_FORMAT = "paddle_tpu_torch-bundle-v1"
# the torch device types a bundle's programs can be listed for
PLATFORMS = ("cpu", "cuda")
# torch.export.load keeps the deserializer of the program it is reading in
# a process-wide global: two loads at once (two bundles warming on two
# threads) fail, so every load of the process takes this lock
_DESERIALIZE_LOCK = threading.Lock()

# input kinds (manifest "kind") -> flat feed keys:
#   dense      f32 [B, dim]                      keys: [name]
#   index      i32 [B]                           keys: [name]
#   seq_index  i32 [B, T] ids + i32 [B] lengths  keys: [name, name+":lens"]
#   seq_dense  f32 [B, T, dim] + i32 [B] lengths keys: [name, name+":lens"]
SEQ_KINDS = ("seq_index", "seq_dense")


def is_bundle(path):
    """True when ``path`` is a bundle directory (manifest present and of
    the bundle format: a parameter tar or a checkpoint directory is not)."""
    manifest = os.path.join(path, MANIFEST_NAME)
    if not (os.path.isdir(path) and os.path.isfile(manifest)):
        return False
    try:
        with open(manifest) as fh:
            return json.load(fh).get("format") == BUNDLE_FORMAT
    except (OSError, ValueError):
        return False


def flat_keys(spec):
    """Flat feed keys of one manifest input spec, in feed order."""
    if spec["kind"] in SEQ_KINDS:
        return [spec["name"], spec["name"] + ":lens"]
    return [spec["name"]]


def sorted_dict(d):
    """``d`` with its keys in sorted order: the order a program's dict
    arguments are exported and called in."""
    return dict(sorted(d.items()))


def _register_ops():
    """Import the kernel modules, which register the ops the programs
    call (``torch.ops.paddle_tpu_torch.*``); a program naming an op that
    is not registered does not load."""
    from paddle_tpu_torch.ops import (conv_kernels, gru_kernels,  # noqa: F401
                                      int8_kernels, lstm_kernels)


def _placement_key(device):
    """The cache key of a device: ``cuda`` names the current card's
    index, so ``cuda`` and ``cuda:0`` share one placement."""
    if device.type == "cuda" and device.index is None:
        return "cuda:%d" % torch.cuda.current_device()
    return str(device)


class Bundle:
    """A loaded bundle: manifest, the parameters resident on ``device``
    (the card unless ``device="cpu"``) and its programs, deserialized at
    first use and cached per bucket and device."""

    def __init__(self, directory, device=None):
        self.directory = os.path.abspath(directory)
        self.device = resolve_device(device)
        with open(os.path.join(self.directory, MANIFEST_NAME)) as fh:
            self.manifest = json.load(fh)
        if self.manifest.get("format") != BUNDLE_FORMAT:
            raise ValueError("%s is not a %s bundle (format=%r)"
                             % (directory, BUNDLE_FORMAT,
                                self.manifest.get("format")))
        self.name = self.manifest.get("name", "model")
        if "builder" in self.manifest or any(
                "artifact" not in b for b in self.manifest["buckets"]):
            raise ValueError(
                "bundle %s holds no exported programs (it names a builder "
                "and was written before the bundle held programs): "
                "re-export it with export_bundle or cli export"
                % directory)
        platforms = self.manifest.get("platforms") or []
        if self.device.type not in platforms:
            raise ValueError(
                "bundle %s has no program for device %s (exported for %s);"
                " re-export with platforms including %r"
                % (directory, self.device, platforms, self.device.type))
        self.inputs = self.manifest["inputs"]
        self.outputs = self.manifest["outputs"]
        self.seq_len = self.manifest.get("seq_len")
        # the quantization block of a quantized bundle: descriptive here,
        # the dequantization is inside the programs
        self.quantization = self.manifest.get("quantization")
        self.buckets = sorted(self.manifest["buckets"],
                              key=lambda b: b["batch"])
        if not self.buckets:
            raise ValueError("bundle %s has no batch buckets" % directory)
        self._out_names = [o["name"] for o in self.outputs]
        # shared by every view of this bundle (``view``): the loads and
        # the per-device caches, under one lock
        self._lock = threading.Lock()
        self._home = _placement_key(self.device)
        self._device_params = {}  # placement key -> {name: tensor}
        self._programs = {}  # (artifact, placement key) -> callable module
        # seconds per deserialized artifact (``artifact@device`` for a
        # view's other device), in load order: their number is the port's
        # counterpart of the JAX bundle's compile count (/debug/compiles)
        self.load_seconds = {}
        with np.load(os.path.join(self.directory,
                                  self.manifest["params_file"])) as pz:
            self._device_params[self._home] = {
                k: torch.from_numpy(np.ascontiguousarray(pz[k]))
                .to(self.device) for k in sorted(pz.files)}
        # the payload on this bundle's device, a plain dict: the programs'
        # first argument (their input spec refuses a dict subclass);
        # ``params(device)`` is the JAX package's accessor
        self.payload = self._device_params[self._home]
        _register_ops()
        # per call: the engine's async warmup thread and its batcher
        # worker may both run a forward; one at a time keeps the device
        # work ordered (each view has its own)
        self._run_lock = threading.Lock()
        self._calls = threading.local()

    @property
    def last_device_ms(self):
        """CUDA-event milliseconds of the calling thread's last ``run`` on
        the card, from before the program's first launch to after its last
        (None on the CPU). Views on one card share its default stream, so
        the interval may hold another view's kernels enqueued meanwhile."""
        return getattr(self._calls, "device_ms", None)

    def _device(self, device):
        """The device a call runs on: ``device``, or the bundle's own."""
        return self.device if device is None else resolve_device(device)

    def params(self, device=None):
        """The parameter payload as tensors on ``device`` (None: the
        bundle's own, ``payload``), copied there from the bundle's device
        at first use and cached per device (paddle_tpu/serve/bundle.py
        ``params(device=None)``)."""
        device = self._device(device)
        key = _placement_key(device)
        # double-checked init: the unlocked read is the per-dispatch fast
        # path; a stale miss only sends the reader into the locked slow
        # path below, which re-reads under _lock (GIL-atomic load)
        values = self._device_params.get(key)  # paddle-lint: disable=PTA005
        if values is None:
            with self._lock:
                values = self._device_params.get(key)
                if values is None:
                    values = {k: v.to(device) for k, v in
                              self._device_params[self._home].items()}
                    self._device_params[key] = values
        return values

    def _load(self, artifact, device=None):
        """The program in ``artifact``, deserialized, moved to ``device``
        (default: the bundle's) and cached at first use per device."""
        device = self._device(device)
        key = _placement_key(device)
        # double-checked init: unlocked dict get is the warm fast path
        # (GIL-atomic); a miss re-checks under _lock below
        program = self._programs.get((artifact, key))  # paddle-lint: disable=PTA005
        if program is None:
            with self._lock:
                program = self._programs.get((artifact, key))
                if program is None:
                    from torch.export.passes import move_to_device_pass

                    t0 = time.perf_counter()
                    with _DESERIALIZE_LOCK:
                        exported = torch.export.load(
                            os.path.join(self.directory, artifact))
                        program = move_to_device_pass(
                            exported, str(device)).module()
                    name = (artifact if key == self._home
                            else "%s@%s" % (artifact, key))
                    self.load_seconds[name] = time.perf_counter() - t0
                    steplog.emit_event(
                        "/paddle_tpu_torch/program_load/" + name,
                        self.load_seconds[name])
                    self._programs[(artifact, key)] = program
        return program

    def view(self, device):
        """A :class:`BundleReplica` of this bundle on ``device``: the unit a
        replica fleet hands each engine (paddle_tpu/serve/bundle.py
        ``view``)."""
        return BundleReplica(self, device)

    def program(self, batch, device=None):
        """The loaded program of one bucket batch size (JAX's
        ``executable(batch)``): ``program(params, flat) -> {output:
        tensor}`` on device tensors, deserialized at first use."""
        bucket = next(b for b in self.buckets if b["batch"] == batch)
        return self._load(bucket["artifact"], device)

    def executable(self, batch, device=None):
        """JAX's name for :meth:`program` (paddle_tpu/serve/bundle.py
        ``executable``)."""
        return self.program(batch, device)

    def decode_executable(self, slots=None, device=None):
        """The loaded decode-step program of one slot capacity (default:
        the largest), as :meth:`decode_step` runs it: ``program(params,
        carry, flat) -> (carry', outputs)``."""
        return self._load(self._decode_bucket(slots)["artifact"], device)

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
    def device_inputs(self, flat, device=None):
        """Flat numpy (or tensor) inputs as tensors on ``device`` (default:
        the bundle's), in sorted key order (a program's argument)."""
        device = self._device(device)
        return {k: torch.as_tensor(v if torch.is_tensor(v)
                                   else np.asarray(v), device=device)
                for k, v in sorted(flat.items())}

    def run(self, flat_inputs, batch, device=None):
        """Run one exact-bucket batch (no padding logic) on ``device``
        (default: the bundle's). Returns ``{output_name: np.ndarray}``
        (float32 for bfloat16 outputs); on the card ``last_device_ms``
        holds the program's time by CUDA events."""
        for key, arr in flat_inputs.items():
            if np.shape(arr)[0] != batch:
                raise ValueError("input %r has %d rows, bucket is %d"
                                 % (key, np.shape(arr)[0], batch))
        device = self._device(device)
        program = self.program(batch, device)
        params = self.params(device)
        with self._run_lock, torch.inference_mode():
            feed = self.device_inputs(flat_inputs, device)
            if device.type != "cuda":
                out = program(params, feed)
                return {name: _host(out[name]) for name in self._out_names}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = program(params, feed)
            end.record()
            # the readback waits for the card, so both events are done
            host = {name: _host(out[name]) for name in self._out_names}
            self._calls.device_ms = start.elapsed_time(end)
            return host

    def warmup(self, device=None):
        """Run every bucket once on dummy inputs on ``device`` (default:
        the bundle's), so the kernels build and the allocator reaches its
        steady state before traffic. Returns the number of buckets run."""
        for bucket in self.buckets:
            self.run(self.dummy_inputs(bucket["batch"]), bucket["batch"],
                     device)
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

    def zero_carry(self, slots=None, device=None):
        """The virgin recurrent carry for one slot capacity,
        ``{recurrent_layer: [zeros [slots, ...], ...]}`` per the manifest's
        carry spec, on ``device`` (default: the bundle's)."""
        slots = int(self._decode_bucket(slots)["slots"])
        device = self._device(device)
        return {layer: [torch.zeros((slots,) + tuple(leaf["shape_suffix"]),
                                    dtype=getattr(torch, leaf["dtype"]),
                                    device=device)
                        for leaf in leaves]
                for layer, leaves in self.manifest["decode"]["carry"].items()}

    def decode_step(self, carry, flat, slots=None, device=None):
        """Run ONE decode window on ``device`` (default: the bundle's):
        ``(carry, flat) -> (carry', outputs)``.
        ``flat`` is ``dummy_decode_flat``'s dict (numpy or tensors); the
        new carry and the [slots, window, ...] outputs stay on the device
        (the scheduler's one readback a window is its own). The step
        returns new carry tensors and never writes ``carry``: callers
        rebind (``carry, outs = bundle.decode_step(carry, ...)``)."""
        bucket = self._decode_bucket(slots)
        slots = int(bucket["slots"])
        lens = flat["lens"]
        if np.shape(lens) != (slots,):
            raise ValueError("decode step for %d slots got lens of shape %s"
                             % (slots, np.shape(lens)))
        device = self._device(device)
        program = self._load(bucket["artifact"], device)
        with self._run_lock, torch.inference_mode():
            return program(self.params(device), sorted_dict(carry),
                           self.device_inputs(flat, device))

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

    def warmup_decoder(self, slots=None, device=None):
        """Run the decode step twice (a fresh carry, then the carry it
        returned) and one slice/insert round trip, as the JAX package's
        warmup does: the kernel libraries load and the allocator reaches
        its steady state before traffic, so paging churn after it builds
        and loads nothing (on ``device``, default: the bundle's). Returns
        the slot capacity."""
        device = self._device(device)
        slot_count = int(self._decode_bucket(slots)["slots"])
        carry = self.zero_carry(slot_count, device)
        for _ in range(2):
            carry, _ = self.decode_step(
                carry, self.dummy_decode_flat(slot_count), slot_count,
                device)
        rows = self.carry_slice(carry, 0)
        host = {layer: [host_leaf(leaf) for leaf in leaves]
                for layer, leaves in rows.items()}
        self.carry_insert(carry, host, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return slot_count

    def infer(self, flat_inputs, rows=None, device=None):
        """Pad ``flat_inputs`` to the nearest bucket, run on ``device``
        (default: the bundle's), slice the padding back off."""
        first = next(iter(flat_inputs.values()))
        rows = int(np.shape(first)[0]) if rows is None else int(rows)
        if rows < 1:
            raise ValueError("cannot infer an empty batch (rows=%d)" % rows)
        self.validate_inputs(flat_inputs)
        bucket = self.bucket_for(rows)
        padded = {k: pad_rows(np.asarray(v), bucket["batch"])
                  for k, v in flat_inputs.items()}
        out = self.run(padded, bucket["batch"], device)
        return {k: arr[:rows] for k, arr in out.items()}

    def __repr__(self):
        quant = (", quantized=%s" % self.quantization["scheme"]
                 if self.quantization else "")
        return "Bundle(%r, buckets=%s, inputs=%s, device=%s%s)" % (
            self.name, self.batch_sizes(), [i["name"] for i in self.inputs],
            self.device, quant)


class BundleReplica(Bundle):
    """A view of a :class:`Bundle` on one device (paddle_tpu/serve/
    bundle.py ``BundleReplica``): the base's manifest, host payload,
    deserialized programs and load lock, with the parameters and programs
    on this view's device (moved there once per device and shared by every
    view on it) and its own run lock and per-thread ``last_device_ms``.
    Every ``Bundle`` entry point runs on the view's device."""

    def __init__(self, base, device):
        self.__dict__.update(base.__dict__)
        self._base = base
        self.device = resolve_device(device)
        self.payload = base.params(self.device)
        self._run_lock = threading.Lock()
        self._calls = threading.local()

    def view(self, device):
        return self._base.view(device)

    def __repr__(self):
        return "BundleReplica(%r, device=%s)" % (self.name, self.device)


def _host(tensor):
    """A program's output as a host array (bfloat16 widened to
    float32)."""
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.cpu().numpy()


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
