"""Dtype policy on torch dtypes.

float32 is the default numeric type (and what serving exports); bfloat16
is the mixed-precision compute type: parameters stay float32 masters and
the forward casts floating tensors to the compute dtype at the topology
boundary.
"""

import torch

from paddle_tpu_torch.utils import flags

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def canonical(dtype):
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, str):
        return _NAMES[dtype]
    if isinstance(dtype, torch.dtype):
        return dtype
    raise TypeError("cannot convert %r to a torch dtype" % (dtype,))


def name_of(dtype):
    """'float32' for torch.float32 (the manifest spelling)."""
    return str(dtype).replace("torch.", "")


def default_dtype():
    return _NAMES[flags.get_flag("default_dtype")]


def set_default_dtype(dtype):
    """Set the ``default_dtype`` flag from a name or a torch dtype."""
    flags.set_flag("default_dtype", dtype if isinstance(dtype, str)
                   else name_of(canonical(dtype)))


def matmul_precision():
    """The ``matmul_precision`` flag's value (the port refuses any other
    than its default: float32 matmuls run with TF32 off)."""
    return flags.get_flag("matmul_precision")


def compute_dtype():
    """Forward-pass compute dtype, or None for 'same as parameters'."""
    name = flags.get_flag("compute_dtype")
    return _NAMES[name] if name else None


def set_mixed_precision(dtype="bfloat16"):
    """Enable (or disable with None/'') the mixed-precision policy."""
    flags.set_flag("compute_dtype", name_of(canonical(dtype)) if dtype else "")


def to_compute(x):
    """Cast a floating tensor to the compute dtype (no-op when unset)."""
    cd = compute_dtype()
    if cd is not None and torch.is_tensor(x) and x.is_floating_point() \
            and x.dtype != cd:
        return x.to(cd)
    return x


def upcast_f32(x):
    """Locally lift low-precision values to float32 (cost layers)."""
    if torch.is_tensor(x) and x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x
