"""Cost layers (reference: gserver/layers/CostLayer.cpp; paddle_tpu/
layer/cost.py): classification_cost, cross_entropy, square_error_cost
(mse_cost, regression_cost), multi_binary_label_cross_entropy
(soft_binary_class_cross_entropy), cross_entropy_with_selfnorm,
rank_cost, lambda_cost, huber_regression_cost, huber_classification_cost
(huber_cost), smooth_l1_cost and sum_cost. Every cost node outputs a
per-sample cost [B] (a sequence cost is summed over the valid timesteps
of each sequence); the trainer takes the mean.

``COST_LAYER_TYPES`` names the layer types whose non-first inputs are
supervision targets (labels, scores, weights): the mixed-precision
policy leaves a data feed read only there in float32
(``Topology._label_feed_names``), as the JAX package does.
"""

import torch

from paddle_tpu_torch.core.dtype import upcast_f32
from paddle_tpu_torch.layer.base import (data_of, is_seq, layer_registry,
                                         make_node, register_layer)

_EPS = 1e-8


def _per_sample(cost_bt, label_or_input):
    """Reduce a per-timestep cost [B, T] to per-sample [B] with masking."""
    if is_seq(label_or_input):
        return torch.sum(cost_bt * label_or_input.mask(cost_bt.dtype), dim=1)
    return cost_bt


def _maybe_weight(cost_b, values, has_weight):
    if has_weight:
        return cost_b * data_of(values[-1]).reshape(cost_b.shape)
    return cost_b


def _pick(x, labels):
    """x[..., label] for integer labels of x's leading shape."""
    return torch.gather(x, -1, labels.long()[..., None])[..., 0]


@register_layer("cross_entropy")
def cross_entropy(input, label, name=None, weight=None, layer_attr=None):
    """-log(p[label]); input carries probabilities (post-softmax)."""
    inputs = [input, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        p, y = values[0], values[1]
        cost = -torch.log(_pick(upcast_f32(data_of(p)), data_of(y)) + _EPS)
        return _maybe_weight(_per_sample(cost, y), values, weight is not None)

    return make_node("cross_entropy", forward, inputs, name=name, size=1,
                     layer_attr=layer_attr)


@register_layer("classification_cost")
def classification_cost(input, label, name=None, weight=None,
                        layer_attr=None):
    """softmax (if needed) + cross entropy in log space, on plain [B, C]
    and sequence [B, T, C] inputs. A softmax-marked input
    (``output_activation``) is taken as probabilities (log(p + 1e-8)),
    anything else as logits (log-softmax)."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    is_probs = getattr(input, "output_activation", None) in (
        "softmax", "sequence_softmax")

    def forward(params, values, ctx):
        x, y = upcast_f32(data_of(values[0])), values[1]
        logp = (torch.log(x + _EPS) if is_probs
                else x - torch.logsumexp(x, dim=-1, keepdim=True))
        cost = -_pick(logp, data_of(y))
        return _maybe_weight(_per_sample(cost, y), values, weight is not None)

    return make_node("classification_cost", forward, inputs, name=name,
                     size=1, layer_attr=layer_attr)


@register_layer("square_error_cost")
def square_error_cost(input, label, name=None, weight=None, layer_attr=None):
    """0.5 * sum((x - y)^2) per sample (reference: SumOfSquaresCostLayer)."""
    inputs = [input, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        x = upcast_f32(data_of(values[0]))
        y = upcast_f32(data_of(values[1]))
        cost = _per_sample(0.5 * torch.sum((x - y) ** 2, dim=-1), values[1])
        return _maybe_weight(cost, values, weight is not None)

    return make_node("square_error_cost", forward, inputs, name=name, size=1,
                     layer_attr=layer_attr)


mse_cost = square_error_cost
regression_cost = square_error_cost


@register_layer("multi_binary_label_cross_entropy")
def multi_binary_label_cross_entropy(input, label, name=None,
                                     layer_attr=None):
    """Independent per-class sigmoid cross entropy against a multi-hot
    label, summed over the classes (reference:
    MultiBinaryLabelCrossEntropy); input carries probabilities."""

    def forward(params, values, ctx):
        p = upcast_f32(data_of(values[0]))
        y = upcast_f32(data_of(values[1]))
        cost = -(y * torch.log(p + _EPS) + (1.0 - y) * torch.log(
            1.0 - p + _EPS))
        return torch.sum(cost, dim=-1)

    return make_node("multi_binary_label_cross_entropy", forward,
                     [input, label], name=name, size=1, layer_attr=layer_attr)


@register_layer("cross_entropy_with_selfnorm")
def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None, layer_attr=None):
    """Cross entropy of the normalized input plus alpha * log(Z)^2, Z the
    input's row sum (reference: CostLayer.cpp CrossEntropyWithSelfNorm)."""

    def forward(params, values, ctx):
        p, y = data_of(values[0]), data_of(values[1])
        z = torch.sum(p, dim=-1)
        cost = -torch.log(_pick(p, y) / (z + _EPS) + _EPS)
        return cost + softmax_selfnorm_alpha * torch.log(z + _EPS) ** 2

    return make_node("cross_entropy_with_selfnorm", forward, [input, label],
                     name=name, size=1, layer_attr=layer_attr)


def _softplus_neg(o):
    """log(1 + exp(-o)), stable on both sides."""
    return torch.log1p(torch.exp(-torch.abs(o))) + torch.clamp(-o, min=0.0)


@register_layer("rank_cost")
def rank_cost(left, right, label, weight=None, name=None, layer_attr=None):
    """Pairwise ranking cost (reference: RankingCost):
    C = (1 - label) * o + log(1 + exp(-o)), o = left - right."""
    inputs = [left, right, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        o = (data_of(values[0]) - data_of(values[1]))[..., 0]
        y = data_of(values[2]).reshape(o.shape)
        cost = (1.0 - y) * o + _softplus_neg(o)
        return _maybe_weight(cost, values, weight is not None)

    return make_node("rank_cost", forward, inputs, name=name, size=1,
                     layer_attr=layer_attr)


@register_layer("lambda_cost")
def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None,
                layer_attr=None):
    """LambdaRank cost over a sequence of documents (reference:
    LambdaCost; paddle_tpu/layer/cost.py:159-188): the pairwise logistic
    surrogate of the model scores, each pair weighted by its positive
    gain difference, over the ideal DCG at ``NDCG_num``. ``input`` holds
    the model's scores, ``score`` the relevances, both [B, T, 1]
    sequences."""

    def forward(params, values, ctx):
        s_pred = values[0]
        x = data_of(s_pred)[..., 0]
        rel = data_of(values[1])[..., 0]
        mask = (s_pred.mask(x.dtype) if is_seq(s_pred)
                else torch.ones_like(x))
        gains = (2.0 ** rel - 1.0) * mask
        sorted_gains = torch.sort(gains, dim=-1, descending=True).values
        k = min(NDCG_num, x.shape[-1])
        discounts = 1.0 / torch.log2(torch.arange(
            2, k + 2, device=x.device).to(x.dtype))
        idcg = torch.sum(sorted_gains[..., :k] * discounts, dim=-1)
        diff = x[..., :, None] - x[..., None, :]
        gd = gains[..., :, None] - gains[..., None, :]
        pair_mask = mask[..., :, None] * mask[..., None, :]
        lam = torch.abs(gd) * pair_mask * (gd > 0).to(x.dtype)
        cost = torch.sum(_softplus_neg(diff) * lam, dim=(-1, -2))
        return cost / torch.clamp(idcg, min=1.0)

    return make_node("lambda_cost", forward, [input, score], name=name,
                     size=1, layer_attr=layer_attr)


@register_layer("huber_regression_cost")
def huber_regression_cost(input, label, delta=1.0, name=None,
                          layer_attr=None):
    """sum over features of 0.5 a^2 for a = |x - y| <= delta, else
    delta (a - delta / 2) (reference: HuberRegressionLoss)."""

    def forward(params, values, ctx):
        x = upcast_f32(data_of(values[0]))
        y = upcast_f32(data_of(values[1]))
        a = torch.abs(x - y)
        cost = torch.where(a <= delta, 0.5 * a * a,
                           delta * (a - 0.5 * delta))
        return torch.sum(cost, dim=-1)

    return make_node("huber_regression_cost", forward, [input, label],
                     name=name, size=1, layer_attr=layer_attr)


@register_layer("huber_classification_cost")
def huber_classification_cost(input, label, name=None, layer_attr=None):
    """Two-class huber (reference: HuberTwoClassification): the label in
    {0, 1} mapped to y in {-1, +1}, z = y f; cost 0 for z > 1, (1 - z)^2
    for -1 <= z <= 1, -4 z below."""

    def forward(params, values, ctx):
        f = data_of(values[0])[..., 0]
        y = 2.0 * data_of(values[1]).reshape(f.shape).to(f.dtype) - 1.0
        z = y * f
        return torch.where(z > 1.0, torch.zeros_like(z),
                           torch.where(z >= -1.0, (1.0 - z) ** 2, -4.0 * z))

    return make_node("huber_classification_cost", forward, [input, label],
                     name=name, size=1, layer_attr=layer_attr)


@register_layer("smooth_l1_cost")
def smooth_l1_cost(input, label, coeff=1.0, name=None, layer_attr=None):
    """coeff * sum over features of 0.5 a^2 for a = |x - y| < 1, else
    a - 0.5 (reference: SmoothL1CostLayer)."""

    def forward(params, values, ctx):
        x = upcast_f32(data_of(values[0]))
        y = upcast_f32(data_of(values[1]))
        a = torch.abs(x - y)
        cost = torch.where(a < 1.0, 0.5 * a * a, a - 0.5)
        return coeff * torch.sum(cost, dim=-1)

    return make_node("smooth_l1_cost", forward, [input, label], name=name,
                     size=1, layer_attr=layer_attr)


@register_layer("sum_cost")
def sum_cost(input, name=None, layer_attr=None):
    """The sum of the input as a cost, a sequence's over its valid steps
    (reference: SumCostLayer)."""

    def forward(params, values, ctx):
        v = values[0]
        x = data_of(v)
        if is_seq(v):
            x = x * v.mask(x.dtype).reshape(
                tuple(v.mask().shape) + (1,) * (x.ndim - 2))
        return torch.sum(x, dim=tuple(range(1, x.ndim)))

    return make_node("sum_cost", forward, [input], name=name, size=1,
                     layer_attr=layer_attr)


huber_cost = huber_classification_cost

# reference SoftBinaryClassCrossEntropy: the multi-binary-label cross
# entropy against per-unit probabilities
soft_binary_class_cross_entropy = multi_binary_label_cross_entropy
layer_registry.register("soft_binary_class_cross_entropy",
                        multi_binary_label_cross_entropy)

# paddle_tpu/layer/cost.py:255-261: the layer types whose inputs after
# the first are supervision targets (crf_decoding's label included; ctc's
# nodes are of type "ctc", warp_ctc being ctc, and "warp_ctc" is kept as
# the JAX package keeps it)
COST_LAYER_TYPES = frozenset({
    "cross_entropy", "classification_cost", "square_error_cost",
    "multi_binary_label_cross_entropy", "cross_entropy_with_selfnorm",
    "rank_cost", "lambda_cost", "huber_regression_cost",
    "huber_classification_cost", "smooth_l1_cost", "sum_cost",
    "crf", "crf_decoding", "ctc", "warp_ctc",
})
