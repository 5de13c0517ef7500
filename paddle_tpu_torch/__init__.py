"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

Same layer DSL, layer names and parameter names as ``paddle_tpu`` (the JAX
package, which stays the reference); PyTorch underneath, and a
hand-written Hopper kernel wherever the JAX package had a Pallas kernel.
Entry points run on the card unless the caller passes ``device="cpu"``, or
``init(use_tpu=False)`` made the CPU the default.

    import paddle_tpu_torch as paddle
    paddle.init(use_tpu=True)   # the card; use_tpu=False runs on the CPU
    from paddle_tpu_torch.models.text import text_classification_lstm
    out = text_classification_lstm(hidden=256, num_layers=2)
    params = paddle.parameters.create(out)
    probs = paddle.infer(out, params, [([3, 1, 4],)])

Ported so far: the serving path of the LSTM text classifier (layers,
topology, parameters, bundle export/load, batching engine, HTTP server),
its training path (classification_cost, optimizer.Momentum, trainer.SGD
with the v2 event stream, parameter tars), and its whole-sequence LSTM
kernels, forward and backward (csrc/lstm_seq_fwd.cu, csrc/lstm_seq_bwd.cu);
the GRU sequence tagger (models.text.sequence_tagging_gru: grumemory,
networks.simple_gru, a per-timestep output and sequence label) served and
trained the same way, over its whole-sequence GRU kernels
(csrc/gru_seq_fwd.cu, csrc/gru_seq_bwd.cu); ResNet (models.vision.resnet:
img_conv, img_pool, batch_norm with running statistics, addto) served and
trained the same way, every stride-1 SAME conv over the implicit-GEMM conv
kernels (csrc/conv2d_same_fwd.cu for the forward and the data gradient,
csrc/conv2d_same_bwdw.cu for the filter gradient); quantized int8 bundles
(serve/quantize.py, export_bundle(quantize="int8")), whose fc weights run
in the dequant-fused matmul kernel (csrc/int8_matmul.cu); GoogleNet,
AlexNet and the BiLSTM-CRF tagger; the Wide&Deep CTR model and the
movielens recommender (models.recommender: sparse_binary_vector and
sparse_vector feeds as core.sparse.SparseRows, the sparse fc, sparse-row
Momentum updates, cos_sim, square_error_cost,
multi_binary_label_cross_entropy, SumPooling), trained, and movielens
also served fp and int8; the attention NMT, trained and decoded by beam
search; and the v2 training loop (data.DeviceFeeder's pinned feed,
length buckets, steps_per_call as captured CUDA graphs, the seven
optimizers, evaluators, durable checkpoints with resume); the v1 config
front end (``config``, the ``paddle`` shim under ``compat/``, ``cli
train/test/time/observe``) and the training telemetry (``observe``: spans,
the step log, metrics, the sentinel, the device attribution); the v2
data side (``reader``, ``dataset``, ``image``) and ``demo``, which runs a
script written against the JAX package unchanged on the port. The
process flags act as in the JAX package, but ``matmul_precision``, which
is refused at any value but its default. The distributed side: the
coordinator, elastic training, multi-process data parallelism over
torch.distributed (``parallel.DataParallel``) and the cluster launcher
(``distributed``). Model interchange and deployment: the ModelConfig
proto without a protobuf runtime (``proto``, ``Topology.to_proto`` /
``from_proto``, ``cli merge_model``), the C API (``capi``), reference
checkpoints (``interop``), record files (``io``), ``plot`` and
``utils.stat.profiler_trace``. The JAX package's submodules load on
first use.
"""

__version__ = "0.1.0"

import importlib as _importlib

from paddle_tpu_torch.core.place import (CPUPlace, Place, TPUPlace,
                                         default_place, device_count,
                                         resolve_device, set_default_device,
                                         set_default_place)
from paddle_tpu_torch.utils import flags as _flags
from paddle_tpu_torch.utils.error import EnforceError, enforce

# The JAX package's public submodules (paddle_tpu/__init__.py:50-55), loaded
# on first use (PEP 562), as are ``infer`` and ``batch``: a process that
# only loads a serving bundle never imports the graph or the layers.
_SUBMODULES = (
    "activation", "attr", "data_type", "layer", "networks", "pooling",
    "initializer", "optimizer", "parameters", "trainer", "event", "inference",
    "evaluator", "reader", "minibatch", "dataset", "parallel", "image",
    "topology", "config", "ops", "models", "interop", "serve", "data",
)
_initialized = False


def __getattr__(name):
    if name in _SUBMODULES:
        mod = _importlib.import_module("paddle_tpu_torch." + name)
        globals()[name] = mod
        return mod
    if name == "infer":
        from paddle_tpu_torch.inference import infer as fn
        return fn
    if name == "batch":
        from paddle_tpu_torch.minibatch import batch as fn
        return fn
    raise AttributeError("module 'paddle_tpu_torch' has no attribute %r"
                         % name)


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES) | {"infer", "batch"})


def init(use_tpu=None, trainer_count=1, seed=None, log_level=None, **kwargs):
    """Initialize the port process-wide (paddle_tpu.init; v2
    ``paddle.init``). ``use_tpu`` picks the default device of every entry
    point: True or None the card, False the CPU. The card stays the
    default, and choosing it on a machine without one raises: the port
    never moves to the CPU on its own. ``seed`` is the default seed of
    parameter initialisation; ``trainer_count`` the data-parallel width
    that ``cli`` builds its mesh with (the ``trainer_count`` flag: the
    ranks of the process group, one device each); other keywords become
    flags, as in the JAX package."""
    global _initialized
    device = "cpu" if use_tpu is False else "cuda"
    resolve_device(device)  # raises for the card on a machine without one
    set_default_device(device)
    _flags.set_flag("use_tpu", device == "cuda")
    _flags.set_flag("trainer_count", int(trainer_count))
    if seed is not None:
        _flags.set_flag("seed", int(seed))
    for key, value in kwargs.items():
        _flags.set_flag(key, value, create=True)
    if log_level is not None:
        from paddle_tpu_torch.utils.logger import set_level

        set_level(log_level)
    _initialized = True


def is_initialized():
    return _initialized
