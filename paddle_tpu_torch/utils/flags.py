"""Global flag registry.

Equivalent of the gflags registry in paddle/utils/Flags.cpp:18-74. Flags
are typed, defaulted, override-able from the environment
(``PADDLE_TPU_TORCH_<NAME>``), and readable anywhere. Modules call
:func:`define_flag` at import time.

The process flags the JAX package acts on are defined here with its
defaults (paddle_tpu/utils/flags.py:74-101). ``matmul_precision``, which
this port does not act on yet, is refused at any value but its default
(``define_flag(..., ported=False)``): ``set_flag``, ``init(**flags)`` and
the environment raise "... is not ported yet" rather than accept a value
and ignore it.
Unknown flags stay accepted, as in the JAX package.
"""

import os
import threading

from paddle_tpu_torch.utils.error import enforce

_lock = threading.RLock()
_defs = {}  # name -> (type, default, help)
_values = {}
_unported = set()  # flags refused at any value but their default


class FlagError(KeyError):
    pass


def _coerce(ftype, raw):
    if ftype is bool and isinstance(raw, str):
        return raw.lower() in ("1", "true", "yes", "on")
    return ftype(raw)


def _check_ported(name, value):
    enforce(name not in _unported or value == _defs[name][1],
            "flag %s=%r is not ported yet (only its default %r is accepted)",
            name, value, _defs[name][1])


def define_flag(name, default, help_str="", ported=True):
    """Register a flag. Environment variable PADDLE_TPU_TORCH_<NAME>
    overrides the default. A flag defined with ``ported=False`` takes no
    value but its default."""
    ftype = type(default)
    with _lock:
        if name in _defs:
            return
        _defs[name] = (ftype, default, help_str)
        if not ported:
            _unported.add(name)
        env = os.environ.get("PADDLE_TPU_TORCH_" + name.upper())
        value = _coerce(ftype, env) if env is not None else default
        _check_ported(name, value)
        _values[name] = value


def get_flag(name):
    with _lock:
        if name not in _values:
            raise FlagError("undefined flag: %r" % name)
        return _values[name]


def set_flag(name, value, create=False):
    with _lock:
        if name not in _defs:
            if not create:
                raise FlagError("undefined flag: %r" % name)
            _defs[name] = (type(value), value, "")
            _values[name] = value
            return
        value = _coerce(_defs[name][0], value)
        _check_ported(name, value)
        _values[name] = value


def all_flags():
    with _lock:
        return dict(_values)


def reset_flag(name):
    with _lock:
        if name in _defs:
            _values[name] = _defs[name][1]


# Core process flags (parity set: paddle/utils/Flags.cpp:18-74).
define_flag("seed", 0, "global RNG seed for parameter initialisation")
define_flag("default_dtype", "float32", "parameter/activation dtype")
define_flag("compute_dtype", "",
            "mixed-precision forward dtype (bfloat16 = bf16 activations "
            "with float32 master params); empty = parameter dtype")
define_flag("log_period", 100, "log train stats every N batches")
define_flag("test_period", 0, "run a test pass every N batches; 0 = per pass")
define_flag("show_layer_stat", False,
            "log per-layer output stats every log_period")
define_flag("show_parameter_stats_period", 0,
            "log per-parameter stats every N batches")
define_flag("telemetry", "", "directory for per-step JSONL telemetry")
define_flag("stats", False, "print + reset the global StatSet at every "
            "EndPass")
define_flag("trap_fpe", False, "fail fast on NaN/Inf: FloatingPointError at "
            "the first step whose loss, gradients or updated parameters hold "
            "one")
# the JAX package acts on this; this port does not yet (it decides TF32)
define_flag("matmul_precision", "highest",
            "matmul precision: default|high|highest", ported=False)
