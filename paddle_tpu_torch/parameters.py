"""Parameters: named tensors with their specs, numpy get/set, the npz
payload and the tar checkpoint format (paddle_tpu/parameters.py; v2
Parameters). Values are a plain ``{name: tensor}`` dict keyed by the JAX
package's names; weights keep the [in, out] layout.

``to_tar`` / ``from_tar`` write and read the JAX package's format
(``manifest.json`` of format ``paddle_tpu-parameters-v1`` plus one ``.npy``
per parameter), so a tar written by either package loads in the other.
"""

import io
import json
import tarfile
import time

import numpy as np
import torch

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.graph import ParamSpec
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.utils.error import enforce

TAR_FORMAT = "paddle_tpu-parameters-v1"


class Parameters:
    def __init__(self, values=None, specs=None):
        self._values = dict(values or {})
        self._specs = dict(specs or {})

    @staticmethod
    def create(topology_or_cost, rng=None, dtype=None, seed=None,
               device=None):
        """Initialize every parameter of a topology, a cost layer or a list
        of layers (v2 paddle.parameters.create parity) on ``device`` (the
        default device of ``core.place`` unless given). ``rng`` is the JAX
        package's keyword: here an int seed or None, the same as ``seed``
        (a JAX key cannot cross to PyTorch)."""
        from paddle_tpu_torch.graph import LayerNode
        from paddle_tpu_torch.topology import Topology

        topo = topology_or_cost
        if isinstance(topo, (LayerNode, list)):
            topo = Topology(topo)
        enforce(isinstance(topo, Topology), "parameters.create takes a "
                "Topology, a layer or a list of layers, got %s",
                type(topo).__name__)
        if rng is not None:
            enforce(isinstance(rng, (int, np.integer))
                    and not isinstance(rng, bool),
                    "parameters.create(rng=...) takes an int seed here, "
                    "got %s", type(rng).__name__)
            enforce(seed is None or int(seed) == int(rng),
                    "parameters.create: rng=%r and seed=%r disagree", rng,
                    seed)
            seed = int(rng)
        return Parameters(topo.init_params(seed=seed, device=device,
                                           dtype=dtype),
                          topo.param_specs())

    def names(self):
        return sorted(self._values)

    def __contains__(self, key):
        return key in self._values

    def __len__(self):
        return len(self._values)

    def get(self, key):
        """The value as a host numpy array: float32 for a bf16 tensor, every
        other dtype (a quantized bundle's int8 included) as it is."""
        t = self._values[key].detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def set(self, key, value):
        enforce(key in self._values, "unknown parameter %r", key)
        old = self._values[key]
        value = torch.as_tensor(np.asarray(value))
        enforce(tuple(value.shape) == tuple(old.shape),
                "shape mismatch for %r: %s vs %s", key, tuple(value.shape),
                tuple(old.shape))
        self._values[key] = value.to(dtype=old.dtype, device=old.device)

    def spec(self, key):
        return self._specs.get(key)

    def partition(self):
        """(trainable, static, state) name lists: static parameters
        (ParamAttr.is_static) receive no updates; state entries are running
        statistics."""
        trainable, static, state = [], [], []
        for name in self.names():
            spec = self._specs.get(name)
            if spec is not None and spec.is_state:
                state.append(name)
            elif spec is not None and spec.attr.is_static:
                static.append(name)
            else:
                trainable.append(name)
        return trainable, static, state

    def as_dict(self):
        """``{name: tensor}``, the form Topology.apply takes."""
        return dict(self._values)

    def update_from(self, values):
        """Take new values for known names, each kept on its own device and
        in its own dtype."""
        for key, val in values.items():
            old = self._values.get(key)
            if old is not None:
                self._values[key] = val.detach().to(dtype=old.dtype,
                                                    device=old.device)

    def to_npz(self, f):
        """Packed flat export of the raw values (the serving bundle's
        parameter payload; same layout as paddle_tpu's to_npz)."""
        np.savez(f, **{name: self.get(name) for name in self.names()})

    @staticmethod
    def from_npz(f, device="cpu"):
        """Load an npz written by either package's ``to_npz`` (names and
        shapes are not checked here; ``convert.params_from_numpy`` checks
        them against a topology)."""
        with np.load(f) as pz:
            return Parameters({k: torch.from_numpy(pz[k]).to(device)
                               for k in pz.files})

    def to_tar(self, f):
        """Write a tar: manifest.json + one .npy per parameter (the JAX
        package's format; bf16 values are written as float32)."""
        tar = tarfile.open(fileobj=f, mode="w")
        manifest = {"format": TAR_FORMAT,
                    "created": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime()),
                    "parameters": {}}
        for name in self.names():
            arr = self.get(name)
            spec = self._specs.get(name)
            manifest["parameters"][name] = {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "is_state": bool(spec.is_state) if spec else False,
                "is_static": bool(spec.attr.is_static) if spec else False,
            }
            payload = io.BytesIO()
            np.save(payload, arr, allow_pickle=False)
            _add(tar, _safe_entry(name) + ".npy", payload.getvalue())
        _add(tar, "manifest.json", json.dumps(manifest, indent=2).encode())
        tar.close()

    @staticmethod
    def from_tar(f, device=None):
        """Load Parameters from a tar written by either package's
        ``to_tar`` onto ``device`` (the card unless ``device="cpu"``); the
        manifest restores the static/state partition."""
        device = resolve_device(device)
        tar = tarfile.open(fileobj=f, mode="r")
        members = {m.name: m for m in tar.getmembers()}
        enforce("manifest.json" in members, "not a paddle_tpu parameter tar")
        manifest = json.loads(tar.extractfile(members["manifest.json"])
                              .read())
        values, specs = {}, {}
        for name, meta in manifest["parameters"].items():
            entry = _safe_entry(name) + ".npy"
            enforce(entry in members, "missing tar entry %r", entry)
            arr = np.load(io.BytesIO(tar.extractfile(members[entry]).read()),
                          allow_pickle=False)
            values[name] = torch.from_numpy(arr).to(device)
            specs[name] = ParamSpec(
                name, arr.shape, Constant(0.0),
                attr=ParamAttr(is_static=bool(meta.get("is_static", False))),
                is_state=bool(meta.get("is_state", False)))
        tar.close()
        return Parameters(values, specs)

    def init_from_tar(self, f):
        """Overwrite matching parameters from a tar (v2 init_from_tar)."""
        other = Parameters.from_tar(f, device="cpu")
        for name in other.names():
            if name in self._values:
                self.set(name, other.get(name))

    def __repr__(self):
        return "Parameters(%d params: %s)" % (len(self),
                                              ", ".join(self.names()[:6]))


def _safe_entry(name):
    return name.replace("/", "__slash__")


def _add(tar, name, data):
    info = tarfile.TarInfo(name=name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


create = Parameters.create
