"""v1 config-DSL surface of the port (compat/paddle/trainer_config_helpers,
mapped onto paddle_tpu_torch; reference: python/paddle/trainer_config_
helpers/__init__.py) so reference config files run verbatim via ``from
paddle.trainer_config_helpers import *``.

It binds every name the JAX package's shim binds, each to the port's
layer, activation, pooling or network of that name; where the JAX shim
itself binds None (``img_conv_group``), so does this one.
"""

from paddle_tpu_torch import activation as _act
from paddle_tpu_torch import attr as _attr
from paddle_tpu_torch import config as _config
from paddle_tpu_torch import layer as _L
from paddle_tpu_torch import networks as _networks
from paddle_tpu_torch import pooling as _pooling

# -- config plane (settings/outputs/data sources/config args) ---------------
from paddle_tpu_torch.config import (  # noqa: F401
    AdaDeltaOptimizer,
    AdaGradOptimizer,
    AdamOptimizer,
    AdamaxOptimizer,
    DecayedAdaGradOptimizer,
    MomentumOptimizer,
    RMSPropOptimizer,
    get_config_arg,
    outputs,
    settings,
    define_py_data_sources2,
)

from paddle_tpu_torch.optimizer import (  # noqa: F401
    L1Regularization,
    L2Regularization,
    ModelAverage,
    Regularization,
)


# -- attrs ------------------------------------------------------------------
ParamAttr = _attr.ParamAttr
ParameterAttribute = _attr.ParamAttr
ExtraAttr = _attr.ExtraAttr
ExtraLayerAttribute = _attr.ExtraAttr

# -- activations (reference: trainer_config_helpers/activations.py) ---------
LinearActivation = _act.Linear
IdentityActivation = _act.Linear
SigmoidActivation = _act.Sigmoid
TanhActivation = _act.Tanh
STanhActivation = _act.STanh
ReluActivation = _act.Relu
BReluActivation = _act.BRelu
SoftReluActivation = _act.SoftRelu
SoftmaxActivation = _act.Softmax
SequenceSoftmaxActivation = _act.SequenceSoftmax
ExpActivation = _act.Exp
LogActivation = _act.Log
AbsActivation = _act.Abs
SquareActivation = _act.Square
SqrtActivation = _act.Sqrt
ReciprocalActivation = _act.Reciprocal


# -- sequence level enums (reference: layers.py AggregateLevel/ExpandLevel) -
class AggregateLevel:
    TO_NO_SEQUENCE = 0   # aggregate whole (nested) sequence -> one row
    TO_SEQUENCE = 1      # aggregate each sub-sequence -> outer sequence
    EACH_TIMESTEP = 0    # legacy aliases
    EACH_SEQUENCE = 1


class ExpandLevel:
    FROM_NO_SEQUENCE = 0
    FROM_SEQUENCE = 1
    FROM_TIMESTEP = 0    # legacy alias


# -- poolings ---------------------------------------------------------------
MaxPooling = _pooling.MaxPooling
AvgPooling = _pooling.AvgPooling
SumPooling = _pooling.SumPooling
SqrtAvgPooling = _pooling.SqrtAvgPooling


# -- layers (v1 *_layer names; reference: layers.py __all__ :33) ------------
def data_layer(name, size, height=None, width=None, **kw):
    """v1 data_layer: the slot TYPE comes from the @provider registered by
    define_py_data_sources2 (by name, or declaration order), falling back
    to a dense vector of ``size``."""
    from paddle_tpu_torch import data_type as _dt

    t = _config.declared_input_type(name)
    if t is None:
        t = _dt.dense_vector(size)
    return _L.data(name=name, type=t, height=height, width=width)


_LAYERS = (
    ("fc_layer", "fc"), ("embedding_layer", "embedding"),
    ("pooling_layer", "pooling"), ("lstmemory", "lstmemory"),
    ("grumemory", "grumemory"), ("recurrent_layer", "recurrent"),
    ("concat_layer", "concat"), ("addto_layer", "addto"),
    ("dropout_layer", "dropout"), ("img_conv_layer", "img_conv"),
    ("img_pool_layer", "img_pool"), ("batch_norm_layer", "batch_norm"),
    ("img_cmrnorm_layer", "img_cmrnorm"), ("spp_layer", "spp"),
    ("maxout_layer", "maxout"), ("pad_layer", "pad"),
    ("crop_layer", "crop"), ("rotate_layer", "rotate"),
    ("conv_shift_layer", "conv_shift"),
    ("bilinear_interp_layer", "bilinear_interp"),
    ("first_seq", "first_seq"), ("last_seq", "last_seq"),
    ("expand_layer", "expand"), ("seq_concat_layer", "seq_concat"),
    ("seq_reshape_layer", "seq_reshape"), ("sub_seq_layer", "sub_seq"),
    ("maxid_layer", "max_id"), ("sampling_id_layer", "sampling_id"),
    ("eos_layer", "eos_id"), ("classification_cost", "classification_cost"),
    ("cross_entropy", "cross_entropy"),
    ("cross_entropy_with_selfnorm", "cross_entropy_with_selfnorm"),
    ("multi_binary_label_cross_entropy",
     "multi_binary_label_cross_entropy"),
    ("square_error_cost", "square_error_cost"),
    ("regression_cost", "square_error_cost"), ("rank_cost", "rank_cost"),
    ("lambda_cost", "lambda_cost"),
    ("huber_cost", "huber_classification_cost"),
    ("smooth_l1_cost", "smooth_l1_cost"), ("sum_cost", "sum_cost"),
    ("crf_layer", "crf"), ("crf_decoding_layer", "crf_decoding"),
    ("ctc_layer", "ctc"), ("warp_ctc_layer", "warp_ctc"),
    ("nce_layer", "nce"), ("hsigmoid_layer", "hsigmoid"),
    ("mixed_layer", "mixed"), ("trans_layer", "trans"),
    ("repeat_layer", "repeat"), ("slope_intercept_layer", "slope_intercept"),
    ("scaling_layer", "scaling"), ("interpolation_layer", "interpolation"),
    ("power_layer", "power"), ("dotmul_operator", "dotmul_operator"),
    ("dotmul_projection", "dotmul_projection"),
    ("full_matrix_projection", "full_matrix_projection"),
    ("identity_projection", "identity_projection"),
    ("table_projection", "table_projection"),
    ("scaling_projection", "scaling_projection"),
    ("trans_full_matrix_projection", "trans_full_matrix_projection"),
    ("context_projection", "context_projection"),
    ("conv_projection", "conv_projection"),
    ("conv_operator", "conv_operator"), ("memory", "memory"),
    ("recurrent_group", "recurrent_group"), ("beam_search", "beam_search"),
    ("StaticInput", "StaticInput"), ("SubsequenceInput", "SubsequenceInput"),
    ("GeneratedInput", "GeneratedInput"), ("get_output_layer", "get_output"),
    ("cos_sim", "cos_sim"), ("linear_comb_layer", "linear_comb"),
    ("bias_layer", "bias"), ("tensor_layer", "tensor"),
    ("selective_fc_layer", "selective_fc"),
    ("block_expand_layer", "block_expand"), ("row_conv_layer", "row_conv"),
    ("print_layer", "print_layer"), ("priorbox_layer", "priorbox"),
    # remaining v1 layer names exercised by the reference config corpus
    ("mse_cost", "mse_cost"), ("hsigmoid", "hsigmoid"),
    ("detection_output_layer", "detection_output"),
    ("multibox_loss_layer", "multibox_loss"),
    ("multiplex_layer", "multiplex"), ("prelu_layer", "prelu"),
    ("gated_unit_layer", "gated_unit"),
    ("sum_to_one_norm_layer", "sum_to_one_norm"),
    ("out_prod_layer", "out_prod"),
)
for _name, _attr_name in _LAYERS:
    globals()[_name] = getattr(_L, _attr_name)

# -- network composites (reference: networks.py) ----------------------------
for _name in ("bidirectional_lstm", "sequence_conv_pool", "simple_attention",
              "simple_gru", "simple_img_conv_pool", "simple_lstm",
              "text_conv_pool", "vgg_16_network", "bidirectional_gru",
              "lstmemory_group", "gru_group"):
    globals()[_name] = getattr(_networks, _name)
img_conv_group = None  # None in the JAX package's shim too


# -- layer_math (reference: trainer_config_helpers/layer_math.py) -----------
class _LayerMath:
    pass


def _register_unary(op_name, act_cls):
    setattr(_LayerMath, op_name,
            staticmethod(lambda x, name=None: _L.addto(input=[x],
                                                       act=act_cls(),
                                                       name=name)))


for _n, _c in (("exp", ExpActivation), ("log", LogActivation),
               ("abs", AbsActivation), ("sigmoid", SigmoidActivation),
               ("tanh", TanhActivation), ("square", SquareActivation),
               ("relu", ReluActivation), ("sqrt", SqrtActivation),
               ("reciprocal", ReciprocalActivation)):
    _register_unary(_n, _c)

layer_math = _LayerMath()

# -- evaluators (reference: trainer_config_helpers/evaluators.py __all__) ---
from paddle_tpu_torch.evaluator import (  # noqa: E402,F401
    auc_evaluator,
    chunk_evaluator,
    classification_error_evaluator,
    classification_error_printer_evaluator,
    column_sum_evaluator,
    ctc_error_evaluator,
    detection_map_evaluator,
    gradient_printer_evaluator,
    maxframe_printer_evaluator,
    maxid_printer_evaluator,
    pnpair_evaluator,
    precision_recall_evaluator,
    seq_classification_error_evaluator,
    seqtext_printer_evaluator,
    sum_evaluator,
    value_printer_evaluator,
)
