"""Carry weights across from the JAX package.

The JAX package's parameters travel as the numpy dict that its
``Parameters`` holds and that ``Parameters.to_npz`` / a bundle's
``params.npz`` store. Names and layouts are the same in both packages
(``<layer>.w0`` weights in [in, out] layout, ``<layer>.wbias`` biases), so
the conversion is a checked copy.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.utils.error import enforce


def check_param_shapes(shapes, topology, quantization=None):
    """Raise unless ``shapes`` (``{name: shape}``) names exactly the
    topology's parameters, each with its declared shape, plus, for a
    quantized payload (``quantization``, the manifest block of
    serve/quantize.py), the scale sidecar of each quantized tensor with
    shape ``[N]``, N its tensor's last dimension. Returns the topology's
    ``{name: ParamSpec}``."""
    specs = topology.param_specs()
    expected = {name: spec.shape for name, spec in specs.items()}
    for name, info in (quantization or {}).get("params", {}).items():
        enforce(name in specs, "quantized parameter %r is not in the "
                "topology", name)
        expected[info["scale"]] = (specs[name].shape[-1],)
    missing = sorted(set(expected) - set(shapes))
    extra = sorted(set(shapes) - set(expected))
    enforce(not missing and not extra,
            "parameter names differ from the topology: missing %s, "
            "unexpected %s", missing, extra)
    for name, shape in expected.items():
        enforce(tuple(shapes[name]) == shape,
                "parameter %r: shape %s, the topology declares %s", name,
                tuple(shapes[name]), shape)
    return specs


def params_from_numpy(np_dict, topology, device=None, dtype=None,
                      quantization=None):
    """``{name: tensor}`` on ``device`` from ``{name: np.ndarray}``.

    Raises when the name sets differ or any shape differs from the
    topology's ParamSpec (``check_param_shapes``, with the scale sidecars
    of a ``quantization`` block). Floating arrays become ``dtype``
    (default: the default dtype policy, float32), except the scale
    sidecars, which stay float32; integer arrays keep their type, and each
    tensor the block lists must be int8."""
    device = resolve_device(device)
    dtype = dtype_mod.canonical(dtype)
    specs = check_param_shapes(
        {name: np.shape(arr) for name, arr in np_dict.items()}, topology,
        quantization)
    qinfo = (quantization or {}).get("params", {})
    sidecars = {info["scale"] for info in qinfo.values()}
    out = {}
    for name in list(specs) + sorted(sidecars):
        arr = np.asarray(np_dict[name])
        enforce(name not in qinfo or arr.dtype == np.int8,
                "quantized parameter %r must be int8, got %s", name,
                arr.dtype)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if name in sidecars:
            t = t.float()
        elif t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out
