"""The layer library (surface parity with paddle_tpu/layer): constructors
building a lazy DAG that paddle_tpu_torch.topology.Topology evaluates.

  io.py         data
  basic.py      fc, embedding, concat, addto, dropout, cos_sim, scaling,
                slope_intercept, interpolation, power, sum_to_one_norm,
                linear_comb, trans, repeat, resize, bias
  conv.py       img_conv, img_pool, batch_norm, img_cmrnorm
  recurrent.py  lstmemory, grumemory, recurrent
  sequence.py   pooling, first_seq, last_seq, expand,
                context_projection_layer, max_id, sampling_id, eos_id,
                print_layer, seq_concat, seq_reshape, seq_slice, sub_seq
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
  extra.py      crf, crf_decoding

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
from paddle_tpu_torch.layer.conv import (batch_norm, img_cmrnorm, img_conv,
                                         img_pool)
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
from paddle_tpu_torch.layer.extra import crf, crf_decoding
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
from paddle_tpu_torch.layer.recurrent import grumemory, lstmemory, recurrent
from paddle_tpu_torch.layer.rnn_group import (BeamSearchControlCallbacks,
                                              BeamSearchGenerator,
                                              GeneratedInput, StaticInput,
                                              SubsequenceInput, beam_search,
                                              get_output, memory,
                                              recurrent_group)
from paddle_tpu_torch.layer.sequence import (context_projection_layer, eos,
                                             eos_id, expand, first_seq,
                                             last_seq, max_id, maxid,
                                             pooling, print_layer,
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
