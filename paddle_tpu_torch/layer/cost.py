"""Cost layers: classification_cost, cross_entropy, square_error_cost
(mse_cost, regression_cost) and multi_binary_label_cross_entropy
(reference: MultiClassCrossEntropy, SumOfSquaresCostLayer,
MultiBinaryLabelCrossEntropy, v2 layer.classification_cost; paddle_tpu/
layer/cost.py:27-122). Every cost node outputs a per-sample cost [B] (a
sequence cost is summed over the valid timesteps of each sequence); the
trainer takes the mean. The other cost layers come with the models that
use them.
"""

import torch

from paddle_tpu_torch.core.dtype import upcast_f32
from paddle_tpu_torch.layer.base import (data_of, is_seq, make_node,
                                         register_layer)

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
