"""v1 config-DSL compatibility module (paddle_tpu/config.py).

Parity with the reference's config front end (python/paddle/trainer_config_
helpers: `settings()` optimizers.py:360, `outputs()` layers.py, data_sources
.py `define_py_data_sources2`; `get_config_arg` config_parser.py — the
`--config_args=k=v,...` template mechanism): a reference-style trainer
config — a Python file calling ``settings(...)``, building layers, and
declaring ``outputs(cost)`` — runs under this framework's CLI
(`python -m paddle_tpu_torch.cli train --config conf.py --config-args k=v`).

The reference evaluated configs in an embedded interpreter that collected
global state into a TrainerConfig proto; here the same calls collect into a
module-level registry the CLI drains with :func:`pop_config`.
"""

import importlib

from paddle_tpu_torch import optimizer as _opt

_pending = None


def _state():
    global _pending
    if _pending is None:
        _pending = {"settings": {}, "outputs": [], "data_sources": {},
                    "config_args": {}, "input_types": None,
                    "data_layer_count": 0}
    return _pending


def reset():
    global _pending
    _pending = None


def set_config_args(arg_string):
    """CLI hook: parse ``k=v,k2=v2`` (reference: --config_args)."""
    st = _state()
    for pair in filter(None, (arg_string or "").split(",")):
        k, _, v = pair.partition("=")
        st["config_args"][k.strip()] = v.strip()


def get_config_arg(name, type_=str, default=None):
    """Read a --config_args value inside a config file (reference:
    config_parser get_config_arg — template parameters for configs)."""
    st = _state()
    if name not in st["config_args"]:
        return default
    raw = st["config_args"][name]
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


# -- settings() (trainer_config_helpers/optimizers.py:360) -------------------
_UNSET = object()


def settings(batch_size=None, learning_rate=_UNSET, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             model_average=None, learning_rate_decay_a=_UNSET,
             learning_rate_decay_b=_UNSET, learning_rate_schedule=_UNSET,
             **extra):
    st = _state()
    method = learning_method or _opt.Momentum(momentum=0.0)
    # Rebuild the lr schedule only when the caller configured it here —
    # unlike reference v1 optimizers, this framework's optimizers accept
    # learning_rate directly, and a hybrid settings(learning_method=
    # Momentum(learning_rate=0.01)) must keep the optimizer's own schedule.
    lr_args = (learning_rate, learning_rate_decay_a, learning_rate_decay_b,
               learning_rate_schedule)
    if any(a is not _UNSET for a in lr_args):
        method.lr_fn = _opt.make_lr_schedule(
            1e-3 if learning_rate is _UNSET else learning_rate,
            0.0 if learning_rate_decay_a is _UNSET else learning_rate_decay_a,
            0.0 if learning_rate_decay_b is _UNSET else learning_rate_decay_b,
            "constant" if learning_rate_schedule is _UNSET
            else learning_rate_schedule)
    if regularization is not None:
        method.regularization = regularization
    if gradient_clipping_threshold is not None:
        method.clip = gradient_clipping_threshold
    if model_average is not None:
        if not isinstance(model_average, float):
            model_average = model_average.decay
        method.model_average = model_average
    st["settings"] = {"batch_size": batch_size, "optimizer": method,
                      **extra}


def outputs(*layers):
    """Declare the config's output/cost layers (reference: outputs() in
    trainer_config_helpers — marks the sub-graph the trainer optimizes)."""
    st = _state()
    flat = []
    for item in layers:
        flat.extend(item if isinstance(item, (list, tuple)) else [item])
    st["outputs"].extend(flat)


def define_py_data_sources2(train_list=None, test_list=None, module=None,
                            obj=None, args=None, train_reader=None,
                            test_reader=None):
    """Data-source declaration (reference: data_sources.py
    define_py_data_sources2 — names a Python module:function data provider).

    Two forms: the reference's ``module``/``obj`` (imported; ``obj`` is
    called with (file_list, **args) and must return a v2-style reader), or
    direct ``train_reader``/``test_reader`` callables.
    """
    st = _state()
    if isinstance(module, (list, tuple)):
        # split data source (reference: data_sources.py — per-split
        # module/obj/args lists: [train, test])
        def pick(v, i):
            return v[i] if isinstance(v, (list, tuple)) else v

        define_py_data_sources2(train_list=train_list, module=pick(module, 0),
                                obj=pick(obj, 0), args=pick(args, 0))
        define_py_data_sources2(test_list=test_list, module=pick(module, 1),
                                obj=pick(obj, 1), args=pick(args, 1))
        return
    if module is not None:
        kwargs = dict(args or {})
        # import lazily UNLESS the module is already loadable: the reference
        # parsed configs without importing providers (the trainer imported
        # them at read time), so a config naming an absent module must
        # still build
        try:
            factory = getattr(importlib.import_module(module), obj)
        except ImportError:
            def factory(file_list, _m=module, _o=obj, **kw):
                return getattr(importlib.import_module(_m), _o)(file_list,
                                                                **kw)
        if getattr(factory, "is_py_data_provider2", False):
            # @provider-decorated (compat/paddle/trainer/PyDataProvider2.py):
            # run the init hook now so data_layer() can bind the slot
            # types the provider declares (reference: data_layer size must
            # match the provider's input_types; here the types ARE the
            # provider's, keyed by name or declaration order)
            st["input_types"] = factory.make_settings(kwargs).input_types
        if train_list is not None:
            st["data_sources"]["train"] = lambda: factory(train_list,
                                                          **kwargs)
        if test_list is not None:
            st["data_sources"]["test"] = lambda: factory(test_list, **kwargs)
    if train_reader is not None:
        st["data_sources"]["train"] = lambda: train_reader
    if test_reader is not None:
        st["data_sources"]["test"] = lambda: test_reader


def declared_input_type(name):
    """Input type a @provider declared for the next data_layer (compat
    front end): dict input_types bind by layer name, list input_types by
    data-layer declaration order. None when no provider is registered."""
    st = _state()
    types = st["input_types"]
    if types is None:
        return None
    if isinstance(types, dict):
        return types.get(name)
    idx = st["data_layer_count"]
    st["data_layer_count"] += 1
    return types[idx] if idx < len(types) else None


def pop_config():
    """Drain the registry (CLI calls this after exec'ing the config file).
    Returns None only when the config used NO v1-DSL call at all — hybrid
    configs (e.g. settings() + their own cost()) keep their declarations."""
    global _pending
    st, _pending = _pending, None
    if not st or not (st["settings"] or st["outputs"] or st["data_sources"]):
        return None
    return st


# v1 optimizer names (trainer_config_helpers/optimizers.py __all__)
MomentumOptimizer = _opt.Momentum
AdamOptimizer = _opt.Adam
AdamaxOptimizer = _opt.Adamax
AdaGradOptimizer = _opt.AdaGrad
DecayedAdaGradOptimizer = _opt.DecayedAdaGrad
AdaDeltaOptimizer = _opt.AdaDelta
RMSPropOptimizer = _opt.RMSProp
