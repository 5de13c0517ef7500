"""`paddle` import-compatibility package of the port (compat/paddle,
mapped onto paddle_tpu_torch).

Lets unmodified reference config files and data providers run against
the port: ``from paddle.trainer_config_helpers import *`` (the v1 config
DSL), ``from paddle.trainer.PyDataProvider2 import *`` (the @provider
data surface) and ``import paddle.v2`` (the v2 API, which IS
paddle_tpu_torch here).

This directory is NOT on sys.path by default: ``paddle_tpu_torch.cli``
puts it there while it executes a --config file, with every ``paddle`` /
``paddle.*`` module already loaded set aside, so the JAX package's shim of
the same name never answers for it (and the other way round).
"""

import sys as _sys

import paddle_tpu_torch as _pt

# paddle.v2 IS the paddle_tpu_torch surface; alias the module tree so
# `import paddle.v2.layer` style imports resolve.
_sys.modules.setdefault("paddle.v2", _pt)
for _name in ("layer", "activation", "attr", "data_type", "pooling",
              "networks", "optimizer", "parameters", "trainer", "event",
              "inference", "evaluator", "reader", "minibatch", "dataset",
              "image"):
    _mod = getattr(_pt, _name, None)  # dataset and image: not ported yet
    if _mod is not None:
        _sys.modules.setdefault("paddle.v2." + _name, _mod)

v2 = _pt
init = _pt.init
