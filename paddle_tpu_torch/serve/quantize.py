"""Weight-only int8 quantization for serving bundles (the port's copy of
paddle_tpu/serve/quantize.py).

Scheme ``int8-sym-perchannel``: a 2D+ floating weight consumed only by
matmul/conv layers (``fc``, ``img_conv``) is stored as ``q = clip(rint(w /
s), -127, 127)`` int8 with one float32 scale per output channel (last
axis), ``s = amax(|w|, other axes) / 127``, in a ``<name>::scale`` sidecar.
Biases and every 1D tensor, batch-norm tables and running statistics,
embedding tables and recurrent cell weights stay full precision.
``quantize_int8`` is the JAX package's numpy code, so the int8 payload of a
bundle is bit-identical in both packages.

At run time the quantized tensors stay int8 on the device. ``fc`` takes
its int8 weight natively (``layer/basic.py`` calls the dequant-fused
kernel ``ops.int8_kernels.int8_matmul`` with the sidecar);
``dequant_for_forward`` dequantizes the other entries (conv weights) at
the top of every forward of ``Bundle.run``, as ``dequant_for_trace`` does
inside the JAX package's exported program.
"""

import numpy as np
import torch

SCHEME_INT8 = "int8-sym-perchannel"
SCALE_SUFFIX = "::scale"

# layer types whose weights are matmul/conv contractions: the only
# consumers worth quantizing. Everything else (embedding gathers, norm
# tables, recurrent cells) stays fp.
QUANTIZABLE_CONSUMERS = frozenset({"fc", "img_conv"})
# consumers that take the int8 weight natively (the layer looks up the
# scale sidecar itself); the others get their weight dequantized at the
# top of the forward
INT8_NATIVE_CONSUMERS = frozenset({"fc"})


def scale_name(param_name):
    """The params-dict key of one quantized tensor's f32 scale sidecar."""
    return param_name + SCALE_SUFFIX


def is_scale_name(name):
    return name.endswith(SCALE_SUFFIX)


def quantize_int8(w):
    """Per-output-channel symmetric int8: ``(q, scale)`` with ``q``
    int8 of ``w``'s shape and ``scale`` f32 ``[out_channels]`` (last
    axis). All-zero channels get scale 1.0 so dequant stays exact."""
    w = np.asarray(w, np.float32)
    if w.ndim < 1:
        raise ValueError("cannot channel-quantize a scalar")
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q, scale):
    """``q * scale`` in the scale's dtype, broadcast over the output-channel
    last axis; numpy arrays or tensors."""
    if torch.is_tensor(q):
        return q.to(scale.dtype) * scale
    return q.astype(scale.dtype) * scale


def quantizable_params(topology, parameters):
    """The quantizable parameters of a built topology: ``{name: {"native":
    bool}}``. A parameter qualifies when it is a floating 2D+ tensor, not
    running state, and every declaring layer is a matmul/conv consumer
    (``QUANTIZABLE_CONSUMERS``); ``native`` is True when every consumer
    also takes int8 weights directly (``INT8_NATIVE_CONSUMERS``)."""
    consumers = {}
    for node in topology.nodes:
        for spec in node.param_specs:
            consumers.setdefault(spec.name, set()).add(node.layer_type)
    out = {}
    for name in parameters.names():
        types = consumers.get(name)
        if not types or not types <= QUANTIZABLE_CONSUMERS:
            continue
        arr = np.asarray(parameters.get(name))
        if arr.ndim < 2 or not np.issubdtype(arr.dtype, np.floating):
            continue
        spec = parameters.spec(name)
        if spec is not None and spec.is_state:
            continue
        out[name] = {"native": types <= INT8_NATIVE_CONSUMERS}
    return out


def quantize_parameters(parameters, topology):
    """Quantize a :class:`~paddle_tpu_torch.parameters.Parameters` payload
    for export: ``(qparams, qmanifest)``. ``qparams`` holds the int8
    tensors and their ``<name>::scale`` float32 sidecars (static specs, on
    the device of the tensor they replace) and every other tensor as it
    was; ``qmanifest`` is the manifest block ``{"scheme", "scale_suffix",
    "params": {name: {"dtype", "scale", "native"}}}``."""
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.graph import ParamSpec
    from paddle_tpu_torch.initializer import Constant
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.utils.error import enforce

    chosen = quantizable_params(topology, parameters)
    enforce(bool(chosen),
            "nothing to quantize: no floating 2D+ parameter is consumed "
            "exclusively by matmul/conv layers (%s)",
            sorted(QUANTIZABLE_CONSUMERS))
    values, specs = {}, {}
    qmanifest = {"scheme": SCHEME_INT8, "scale_suffix": SCALE_SUFFIX,
                 "params": {}}
    tensors = parameters.as_dict()
    for name in parameters.names():
        tensor = tensors[name]
        spec = parameters.spec(name)
        if name in chosen:
            q, scale = quantize_int8(parameters.get(name))
            sname = scale_name(name)
            values[name] = torch.from_numpy(q).to(tensor.device)
            values[sname] = torch.from_numpy(scale).to(tensor.device)
            specs[name] = ParamSpec(name, q.shape, Constant(0.0),
                                    attr=ParamAttr(is_static=True))
            specs[sname] = ParamSpec(sname, scale.shape, Constant(1.0),
                                     attr=ParamAttr(is_static=True))
            qmanifest["params"][name] = {
                "dtype": "int8", "scale": sname,
                "native": bool(chosen[name]["native"]),
            }
        else:
            values[name] = tensor
            if spec is not None:
                specs[name] = spec
    return Parameters(values, specs), qmanifest


def dequant_for_forward(params, quantization):
    """The top of every quantized forward (``Bundle.run``): the non-native
    int8 entries of ``params`` dequantized to float32 for this forward, the
    native ones passed through as int8 (their layers fetch their own scale
    sidecars). The resident tensors stay int8."""
    out = dict(params)
    for name, info in quantization.get("params", {}).items():
        if name in out and not info.get("native"):
            out[name] = dequantize(out[name], out[scale_name(name)])
    return out
