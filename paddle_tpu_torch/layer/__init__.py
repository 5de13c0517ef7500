"""The layer library (surface parity with paddle_tpu/layer): constructors
building a lazy DAG that paddle_tpu_torch.topology.Topology evaluates.

  io.py         data
  basic.py      fc, embedding, concat, addto, dropout, cos_sim, scaling,
                slope_intercept, interpolation, power, sum_to_one_norm,
                linear_comb, trans, repeat, resize, bias
  conv.py       img_conv (trans=True too), img_pool, batch_norm,
                img_cmrnorm, spp, maxout, pad, crop, rotate, conv_shift,
                bilinear_interp
  recurrent.py  lstmemory, grumemory, recurrent, mdlstmemory
  sequence.py   pooling, first_seq, last_seq, expand,
                context_projection_layer, row_conv, block_expand, max_id,
                sampling_id, eos_id, print_layer, seq_concat, seq_reshape,
                seq_slice, sub_seq
  step.py       lstm_step, gru_step, gru_step_naive (one step, inside a
                group)
  rnn_group.py  recurrent_group, memory, StaticInput, GeneratedInput,
                SubsequenceInput, get_output, beam_search,
                BeamSearchControlCallbacks, BeamSearchGenerator
  attention_utils.py  sequence_softmax_pool (networks.simple_attention)
  cost.py       classification_cost, cross_entropy, square_error_cost
                (mse_cost, regression_cost),
                multi_binary_label_cross_entropy, cross_entropy_with_selfnorm,
                rank_cost, lambda_cost, huber_regression_cost,
                huber_classification_cost, smooth_l1_cost, sum_cost
  mixed.py      mixed + the projections and operators
  extra.py      crf, crf_decoding, ctc, warp_ctc, nce, hsigmoid,
                data_norm, featmap_expand
  misc.py       tensor, selective_fc, out_prod, multiplex, prelu,
                gated_unit
  detection.py  priorbox, cross_channel_norm, multibox_loss,
                detection_output

``recurrent`` is the layer function, as in the JAX package, not the
submodule of the same name.
"""

from paddle_tpu_torch.graph import LayerNode, LayerOutput, reset_name_counters
from paddle_tpu_torch.layer.base import layer_registry
from paddle_tpu_torch.layer.basic import (addto, bias, concat, convex_comb,
                                          cos_sim, dropout, embedding, fc,
                                          interpolation, linear_comb, power,
                                          repeat, resize, scaling,
                                          slope_intercept, sum_to_one_norm,
                                          trans)
from paddle_tpu_torch.layer.conv import (batch_norm, bilinear_interp,
                                         conv_shift, crop, img_cmrnorm,
                                         img_conv, img_pool, maxout, pad,
                                         rotate, spp)
from paddle_tpu_torch.layer.cost import (
    classification_cost,
    cross_entropy,
    cross_entropy_with_selfnorm,
    huber_classification_cost,
    huber_cost,
    huber_regression_cost,
    lambda_cost,
    mse_cost,
    multi_binary_label_cross_entropy,
    rank_cost,
    regression_cost,
    smooth_l1_cost,
    soft_binary_class_cross_entropy,
    square_error_cost,
    sum_cost,
)
from paddle_tpu_torch.layer.detection import (cross_channel_norm,
                                              detection_output,
                                              multibox_loss, priorbox)
from paddle_tpu_torch.layer.extra import (crf, crf_decoding, ctc, data_norm,
                                          featmap_expand, hsigmoid, nce,
                                          warp_ctc)
from paddle_tpu_torch.layer.io import data
from paddle_tpu_torch.layer.mixed import (
    BaseProjection,
    context_projection,
    conv_operator,
    conv_projection,
    dotmul_operator,
    dotmul_projection,
    full_matrix_projection,
    identity_projection,
    mixed,
    scaling_projection,
    table_projection,
    trans_full_matrix_projection,
)
from paddle_tpu_torch.layer.misc import (gated_unit, multiplex, out_prod,
                                         prelu, selective_fc, tensor)
from paddle_tpu_torch.layer.recurrent import (grumemory, lstmemory,
                                              mdlstmemory, recurrent)
from paddle_tpu_torch.layer.rnn_group import (BeamSearchControlCallbacks,
                                              BeamSearchGenerator,
                                              GeneratedInput, StaticInput,
                                              SubsequenceInput, beam_search,
                                              get_output, memory,
                                              recurrent_group)
from paddle_tpu_torch.layer.sequence import (block_expand,
                                             context_projection_layer, eos,
                                             eos_id, expand, first_seq,
                                             last_seq, max_id, maxid,
                                             pooling, print_layer, row_conv,
                                             sampling_id, seq_concat,
                                             seq_reshape, seq_slice,
                                             sub_seq)
from paddle_tpu_torch.layer.step import gru_step, gru_step_naive, lstm_step

# aliases of the v2 naming
pooling_layer = pooling
embedding_layer = embedding
fc_layer = fc
data_layer = data
# alias of the v1 DSL (reference: printer_layer)
printer = print_layer

# the reference's REGISTER_LAYER type names that select a constructor
# (paddle_tpu/layer/__init__.py:160-192)
import functools as _functools

from paddle_tpu_torch import pooling as _pooling

for _ref_name, _our_name in {
    "exconv": "img_conv", "cudnn_conv": "img_conv",
    "cudnn_batch_norm": "batch_norm",
    "seqlastins": "last_seq", "seqconcat": "seq_concat",
    "seqreshape": "seq_reshape", "subseq": "sub_seq",
    "blockexpand": "block_expand", "maxid": "max_id",
    "cos": "cos_sim", "cos_vm": "cos_sim",
    "convex_comb": "linear_comb", "concat2": "concat",
    "huber": "huber_classification_cost",
    "square_error": "square_error_cost", "smooth_l1": "smooth_l1_cost",
    "gated_recurrent": "grumemory",
    "multi_class_cross_entropy_with_selfnorm": "cross_entropy_with_selfnorm",
    "recurrent_layer_group": "recurrent_group",
    "warp_ctc": "ctc",
}.items():
    if _ref_name not in layer_registry and _our_name in layer_registry:
        layer_registry.register(_ref_name, layer_registry.get(_our_name))

for _ref_name, _bound in {
    "exconvt": _functools.partial(img_conv, trans=True),
    "cudnn_convt": _functools.partial(img_conv, trans=True),
    "average": _functools.partial(pooling,
                                  pooling_type=_pooling.AvgPooling()),
    "max": _functools.partial(pooling, pooling_type=_pooling.MaxPooling()),
}.items():
    if _ref_name not in layer_registry:
        layer_registry.register(_ref_name, _bound)
