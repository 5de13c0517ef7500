"""Global flag registry.

Equivalent of the gflags registry in paddle/utils/Flags.cpp:18-74. Flags
are typed, defaulted, override-able from the environment
(``PADDLE_TPU_TORCH_<NAME>``), and readable anywhere. Modules call
:func:`define_flag` at import time.

The JAX package's core process flags are defined here with its defaults
and help (paddle_tpu/utils/flags.py:69-101). ``matmul_precision`` and
``enable_x64``, which this port does not act on, are refused at any value
but their default (``define_flag(..., ported=False)``): ``set_flag``,
``init(**flags)`` and the environment raise "... is not ported yet"
rather than accept a value and ignore it. ``use_tpu`` is set by ``init``
(True: the card); the others are read nowhere, as in the JAX package,
whose CLI options and trainer arguments carry the same settings.
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
define_flag("use_tpu", True, "run compute on the card (cf. --use_gpu); "
            "init(use_tpu=False) makes the CPU the default device")
define_flag("seed", 0, "global RNG seed for parameter initialisation")
define_flag("trainer_count", 1, "data-parallel width (cf. --trainer_count)")
define_flag("trainer_id", 0,
            "distinct id per trainer process (cf. --trainer_id)")
define_flag("checkgrad_eps", 1e-4, "perturbation for numeric gradient checking")
define_flag("prefetch_batches", 4, "data-provider background prefetch depth")
define_flag("save_dir", "", "checkpoint output directory (cf. --save_dir)")
define_flag("init_model_path", "",
            "load parameters from this path before training")
define_flag("start_pass", 0, "resume pass number (cf. --start_pass)")
define_flag("num_passes", 1, "number of training passes (cf. --num_passes)")
define_flag("coordinator_endpoint", "",
            "host:port of the elastic coordinator service")
define_flag("num_shards_per_task", 8, "dataset chunks per coordinator task")
define_flag("task_timeout_sec", 600.0,
            "coordinator task timeout (cf. go/master timeoutDur)")
define_flag("task_failure_max", 3,
            "drop a task after N failures (cf. go/master failureMax)")
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
# the JAX package acts on these; this port does not (it decides TF32, and
# its dtypes are torch's)
define_flag("matmul_precision", "highest",
            "matmul precision: default|high|highest", ported=False)
define_flag("enable_x64", False, "enable float64/int64 (cf. WITH_DOUBLE)",
            ported=False)
