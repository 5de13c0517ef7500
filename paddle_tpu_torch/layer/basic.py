"""Core dense layers: fc, embedding, concat, addto, dropout, cos_sim and
the short elementwise layers scaling, slope_intercept, interpolation,
power, sum_to_one_norm, linear_comb (convex_comb), trans, repeat, resize
and bias (reference: FullyConnectedLayer, TableProjection /
embedding_layer, ConcatenateLayer, AddtoLayer, CosSimLayer, ScalingLayer,
SlopeInterceptLayer, InterpolationLayer, PowerLayer, SumToOneNormLayer,
LinearCombinationLayer, TransLayer, FeatureMapExpandLayer, ResizeLayer,
BiasLayer; v2 layer.dropout; paddle_tpu/layer/basic.py).
Weights keep the JAX package's [in, out] layout, so ``x @ w`` and
parameters copy across unchanged. An fc weight of a quantized bundle
(serve/quantize.py) is int8 with a ``<name>::scale`` sidecar and runs in
the dequant-fused kernel ``ops.int8_kernels.int8_matmul``. An fc input
of SparseRows (a sparse slot at or above ``sparse_feed_threshold``)
takes the row gather of core/sparse.py, for an int8 weight too."""

import torch

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.attr import ExtraAttr
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.layer.base import (
    ImageValue,
    as_nhwc,
    bias_spec,
    data_of,
    featurewise,
    finalize,
    is_seq,
    like,
    make_node,
    mark_activation,
    register_layer,
    to_list,
    weight_spec,
)
from paddle_tpu_torch.ops.int8_kernels import int8_matmul
from paddle_tpu_torch.serve.quantize import scale_name
from paddle_tpu_torch.utils.error import enforce


@register_layer("fc")
def fc(input, size, act=None, name=None, param_attr=None, bias_attr=None,
       layer_attr=None):
    """Fully connected layer over one or more inputs (summed), with bias
    and activation."""
    inputs = to_list(input)
    enforce(len(inputs) >= 1, "fc needs at least one input")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("fc_layer")
    attrs = (param_attr if isinstance(param_attr, (list, tuple))
             else [param_attr] * len(inputs))
    specs = [weight_spec(name, i, (inp.size, size), attrs[i],
                         fan_in=inp.size)
             for i, inp in enumerate(inputs)]
    bspec = bias_spec(name, (size,), bias_attr)

    def matmul(value, spec, params):
        w = params[spec.name]
        if w.dtype == torch.int8:
            # quantized bundle: the int8 weight stays int8 on the device and
            # the kernel dequantizes it with its float32 sidecar (a bfloat16
            # policy has rounded the sidecar; the kernel takes it widened)
            scale = params[scale_name(spec.name)].float()
            if isinstance(value, SparseRows):
                # the gather converts only the K picked int8 rows
                # (core/sparse.py); the per-output-channel scale commutes
                # past the row sum
                return value.matmul(w) * scale
            return featurewise(lambda d: int8_matmul(d, w, scale), value)
        if isinstance(value, SparseRows):
            # the sparse fast path: row gather + weighted K-sum, K * size
            # reads instead of dim * size
            return value.matmul(w)
        return featurewise(lambda d: torch.matmul(d, w), value)

    def sharded(params, values, ax):
        """ExtraAttr(sharding=(..., axis)) under use_mesh: this rank
        multiplies by its columns only; the consumers get the gathered
        value (parallel/collectives.py: the input's gradient summed over
        the axis, each weight's gathered whole)."""
        from paddle_tpu_torch.parallel.collectives import (copy_to, gather,
                                                           split)

        out = None
        for value, spec in zip(values, specs):
            w = split(params[spec.name], ax, 1)
            part = featurewise(lambda d: torch.matmul(copy_to(d, ax), w),
                               value)
            out = part if out is None else like(out, data_of(out)
                                                + data_of(part))
        if bspec is not None:
            out = like(out, data_of(out) + split(params[bspec.name], ax, 0))
        data = data_of(out)
        return like(out, gather(data, ax, data.dim() - 1))

    def forward(params, values, ctx):
        from paddle_tpu_torch.parallel.mesh import layer_column_axis

        ax = layer_column_axis(node.extra_attr)
        if ax is not None and not any(
                isinstance(v, SparseRows) for v in values) and all(
                params[s.name].dtype != torch.int8 for s in specs):
            return finalize(sharded(params, values, ax), act,
                            node.extra_attr, ctx)
        out = matmul(values[0], specs[0], params)
        for value, spec in zip(values[1:], specs[1:]):
            out = like(out, data_of(out) + data_of(matmul(value, spec,
                                                          params)))
        if bspec is not None:
            out = like(out, data_of(out) + params[bspec.name])
        return finalize(out, act, node.extra_attr, ctx)

    node = make_node("fc", forward, inputs, name=name, size=size,
                     param_specs=[s for s in specs + [bspec] if s is not None],
                     layer_attr=layer_attr)
    return mark_activation(node, act)


@register_layer("embedding")
def embedding(input, size, name=None, param_attr=None, layer_attr=None):
    """Embedding lookup: int ids -> rows of a dense [vocab, size] table.
    Ids are clipped to [0, vocab-1] as paddle_tpu/layer/basic.py does."""
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("embedding_layer")
    vocab = input.size
    spec = weight_spec(name, 0, (vocab, size), param_attr, fan_in=size)

    def forward(params, values, ctx):
        table = params[spec.name]

        def gather(ids):
            return table[torch.clamp(ids, 0, vocab - 1).long()]

        return featurewise(gather, values[0])

    return make_node("embedding", forward, [input], name=name, size=size,
                     param_specs=[spec], layer_attr=layer_attr)


@register_layer("addto")
def addto(input, name=None, act=None, bias_attr=False, layer_attr=None):
    """Elementwise sum of the inputs, plus an optional bias, then the
    activation (reference: AddtoLayer). Image inputs of one shape without
    a bias (ResNet's residual add) are summed as NHWC tensors and stay an
    ImageValue."""
    inputs = to_list(input)
    enforce(len(inputs) >= 1, "addto needs at least one input")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("addto_layer")
    size = inputs[0].size
    bspec = bias_spec(name, (size,), bias_attr)
    shapes = [getattr(i, "out_img_shape", None) for i in inputs]
    img_ok = all(s is not None for s in shapes) and len(set(shapes)) == 1

    def forward(params, values, ctx):
        if (img_ok and bspec is None and not any(is_seq(v) for v in values)
                and to_activation(act).elementwise):
            y = as_nhwc(values[0], *shapes[0])
            for v in values[1:]:
                y = y + as_nhwc(v, *shapes[0])
            return finalize(ImageValue(y, shapes[0]), act, node.extra_attr,
                            ctx)
        out = data_of(values[0])
        for v in values[1:]:
            out = out + data_of(v)
        if bspec is not None:
            out = out + params[bspec.name]
        return finalize(like(values[0], out), act, node.extra_attr, ctx)

    node = make_node("addto", forward, inputs, name=name, size=size,
                     param_specs=[bspec] if bspec else [],
                     layer_attr=layer_attr)
    if img_ok:
        node.out_img_shape = shapes[0]
    return mark_activation(node, act)


@register_layer("concat")
def concat(input, name=None, act=None, layer_attr=None):
    """Feature-axis concatenation (reference: ConcatenateLayer;
    paddle_tpu/layer/basic.py:123-166). A projection among the inputs
    (the v1 DSL's concat_layer over projections) becomes a one-branch
    ``mixed`` layer first, as in the JAX package. Images of one height
    and width are joined on the NHWC channel axis and stay an ImageValue
    (the node's ``out_img_shape`` sums their channels); other inputs are
    joined on their last axis: flat rows, or sequences (the lengths of
    the first input) as the BiLSTM's two directions."""
    from paddle_tpu_torch.layer.mixed import BaseProjection, mixed

    inputs = [mixed(input=[i], size=i.size or i.input.size)
              if isinstance(i, BaseProjection) else i
              for i in to_list(input)]
    enforce(len(inputs) >= 1, "concat needs at least one input")
    enforce(all(isinstance(i, LayerNode) for i in inputs),
            "concat takes layers and projections, got %r",
            [type(i).__name__ for i in inputs])
    shapes = [getattr(i, "out_img_shape", None) for i in inputs]
    img_ok = (all(s is not None for s in shapes)
              and len({s[1:] for s in shapes}) == 1)
    out_shape = ((sum(s[0] for s in shapes),) + shapes[0][1:] if img_ok
                 else None)

    def forward(params, values, ctx):
        if img_ok and not any(is_seq(v) for v in values):
            y = torch.cat([as_nhwc(v, *s) for v, s in zip(values, shapes)],
                          dim=-1)
            return finalize(ImageValue(y, out_shape), act, node.extra_attr,
                            ctx)
        out = torch.cat([data_of(v) for v in values], dim=-1)
        return finalize(like(values[0], out), act, node.extra_attr, ctx)

    node = make_node("concat", forward, inputs, name=name,
                     size=sum(i.size for i in inputs), layer_attr=layer_attr)
    if img_ok:
        node.out_img_shape = out_shape
    return node


@register_layer("dropout")
def dropout(input, dropout_rate, name=None):
    """Standalone dropout (v2 layer.dropout; paddle_tpu/layer/basic.py:
    211-222): the input unchanged in test mode; in train mode each
    element kept with probability ``1 - dropout_rate`` and scaled by its
    inverse (``layer.base.finalize``)."""

    def forward(params, values, ctx):
        return finalize(values[0], None, node.extra_attr, ctx)

    node = make_node("dropout", forward, [input], name=name, size=input.size,
                     layer_attr=ExtraAttr(drop_rate=dropout_rate))
    return node


@register_layer("cos_sim")
def cos_sim(a, b, scale=1.0, size=1, name=None, layer_attr=None):
    """Cosine similarity times ``scale`` (reference: CosSimLayer;
    paddle_tpu/layer/basic.py:291-312). With ``size`` > 1, b is [B,
    size * dim], read as ``size`` vectors each compared against a."""

    def forward(params, values, ctx):
        x, y = data_of(values[0]), data_of(values[1])
        if size > 1:
            y = y.reshape(y.shape[:-1] + (size, x.shape[-1]))
            xx = x[..., None, :]
        else:
            xx = x
        dot = torch.sum(xx * y, dim=-1)
        nx = torch.sqrt(torch.clamp(torch.sum(xx * xx, dim=-1), min=1e-12))
        ny = torch.sqrt(torch.clamp(torch.sum(y * y, dim=-1), min=1e-12))
        out = scale * dot / (nx * ny)
        if size == 1:
            out = out[..., None]
        return like(values[0], out)

    return make_node("cos_sim", forward, [a, b], name=name, size=size,
                     layer_attr=layer_attr)


@register_layer("scaling")
def scaling(input, weight, name=None, layer_attr=None):
    """Row-wise scale: out[i, :] = w[i] * in[i, :], ``weight`` a width-1
    layer (reference: ScalingLayer)."""

    def forward(params, values, ctx):
        return like(values[0], data_of(values[0]) * data_of(values[1]))

    return make_node("scaling", forward, [input, weight], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("slope_intercept")
def slope_intercept(input, slope=1.0, intercept=0.0, name=None,
                    layer_attr=None):
    """out = slope * in + intercept (reference: SlopeInterceptLayer)."""

    def forward(params, values, ctx):
        return featurewise(lambda d: slope * d + intercept, values[0])

    return make_node("slope_intercept", forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("interpolation")
def interpolation(input, weight, name=None, layer_attr=None):
    """out = w * a + (1 - w) * b for ``input`` [a, b], ``weight`` a width-1
    layer (reference: InterpolationLayer)."""
    inputs = to_list(input)
    enforce(len(inputs) == 2, "interpolation needs exactly two inputs")

    def forward(params, values, ctx):
        a, b, w = (data_of(v) for v in values)
        return like(values[0], w * a + (1.0 - w) * b)

    return make_node("interpolation", forward, inputs + [weight], name=name,
                     size=inputs[0].size, layer_attr=layer_attr)


@register_layer("power")
def power(input, weight, name=None, layer_attr=None):
    """out[i, :] = in[i, :] ** w[i], ``weight`` a width-1 layer
    (reference: PowerLayer)."""

    def forward(params, values, ctx):
        return like(values[0],
                    torch.pow(data_of(values[0]), data_of(values[1])))

    return make_node("power", forward, [input, weight], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("sum_to_one_norm")
def sum_to_one_norm(input, name=None, layer_attr=None):
    """Each row divided by its sum (at least 1e-12) (reference:
    SumToOneNormLayer)."""

    def forward(params, values, ctx):
        def norm(d):
            return d / torch.clamp(torch.sum(d, dim=-1, keepdim=True),
                                   min=1e-12)

        return featurewise(norm, values[0])

    return make_node("sum_to_one_norm", forward, [input], name=name,
                     size=input.size, layer_attr=layer_attr)


@register_layer("linear_comb")
def linear_comb(weights, vectors, size=None, name=None, layer_attr=None):
    """z = sum_m w[m] * x[m, :] for weights [B, M] and vectors [B, M*size]
    (reference: LinearCombinationLayer / ConvexCombinationLayer; ``size``
    defaults to vectors.size // weights.size)."""
    if size is None:
        size = vectors.size // weights.size

    def forward(params, values, ctx):
        w, v = data_of(values[0]), data_of(values[1])
        v = v.reshape(tuple(v.shape[:-1]) + (w.shape[-1], size))
        return like(values[0], torch.einsum("...m,...ms->...s", w, v))

    return make_node("linear_comb", forward, [weights, vectors], name=name,
                     size=size, layer_attr=layer_attr)


convex_comb = linear_comb


@register_layer("trans")
def trans(input, name=None, layer_attr=None):
    """The transpose of the input's trailing two axes, as the JAX
    package's layer computes it (reference: TransLayer)."""

    def forward(params, values, ctx):
        x = data_of(values[0])
        enforce(x.dim() >= 2, "trans expects matrix-like input")
        return like(values[0], x.transpose(-1, -2))

    return make_node("trans", forward, [input], name=name, size=input.size,
                     layer_attr=layer_attr)


@register_layer("repeat")
def repeat(input, num_repeats, name=None, act=None, as_row_vector=True,
           layer_attr=None):
    """Tile the features ``num_repeats`` times (reference:
    FeatureMapExpandLayer): as_row_vector [a b] -> [a b a b ...], else
    [a a ... b b ...]; then the activation."""

    def forward(params, values, ctx):
        x = data_of(values[0])
        if as_row_vector:
            out = x.repeat((1,) * (x.dim() - 1) + (num_repeats,))
        else:
            out = torch.repeat_interleave(x, num_repeats, dim=-1)
        return finalize(like(values[0], out), act, node.extra_attr, ctx)

    node = make_node("repeat", forward, [input], name=name,
                     size=input.size * num_repeats, layer_attr=layer_attr)
    return node


@register_layer("resize")
def resize(input, size, name=None, layer_attr=None):
    """[B, in] reshaped to [B * in / size, size] (reference: ResizeLayer)."""

    def forward(params, values, ctx):
        return data_of(values[0]).reshape(-1, size)

    return make_node("resize", forward, [input], name=name, size=size,
                     layer_attr=layer_attr)


@register_layer("bias")
def bias(input, name=None, act=None, bias_attr=None, layer_attr=None):
    """The input plus a learned bias, then the activation (reference:
    BiasLayer)."""
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("bias_layer")
    bspec = bias_spec(name, (input.size,),
                      bias_attr if bias_attr is not None else True)

    def forward(params, values, ctx):
        out = featurewise(lambda d: d + params[bspec.name], values[0])
        return finalize(out, act, node.extra_attr, ctx)

    node = make_node("bias", forward, [input], name=name, size=input.size,
                     param_specs=[bspec], layer_attr=layer_attr)
    return node
