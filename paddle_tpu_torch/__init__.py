"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

Same layer DSL, layer names and parameter names as ``paddle_tpu`` (the JAX
package, which stays the reference); PyTorch underneath, and a
hand-written Hopper kernel wherever the JAX package had a Pallas kernel.
Entry points run on the card unless the caller passes ``device="cpu"``.

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.text import text_classification_lstm
    out = text_classification_lstm(hidden=256, num_layers=2)
    params = paddle.parameters.create(paddle.topology.Topology(out))
    probs = paddle.inference.infer(out, params, [([3, 1, 4],)])

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
in the dequant-fused matmul kernel (csrc/int8_matmul.cu).
"""

__version__ = "0.1.0"

from paddle_tpu_torch import (activation, attr, data_type, event, inference,
                              layer, networks, optimizer, parameters, pooling,
                              topology, trainer)
from paddle_tpu_torch.minibatch import batch
from paddle_tpu_torch.utils.error import EnforceError, enforce
