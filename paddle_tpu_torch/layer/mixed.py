"""Mixed layer: a sum of projections and operators, then a bias and an
activation (reference: MixedLayer.cpp, Projection.h, Operator.h; DSL
mixed_layer with full_matrix_projection etc.; paddle_tpu/layer/mixed.py).

A projection owns its parameters (full_matrix, trans_full_matrix,
identity, table, dotmul, scaling, context, conv); an operator has none
(dotmul, conv). Parameter names, shapes and layouts are the JAX
package's: branch ``i`` of the mixed layer ``name`` owns
``"<name>.w<i>"`` (conv_projection's filter HWIO (fh, fw, C/groups, F)),
so parameters carry across between the packages unchanged.

conv_projection and conv_operator convolve through ``ops.conv.conv2d``,
which sends a conv in the hand-written kernels' family (stride 1, SAME,
odd k <= 3, C and F multiples of 8) to K7 forward and data gradient and
K8, and every other conv to ``F.conv2d``; conv_operator convolves each
sample with its own filter, one ``conv2d`` call a sample. Their output is
the flat NCHW feature map, as in the JAX package.
"""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.layer.base import (
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
    reject_packed,
    to_list,
    weight_spec,
)
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import enforce


class BaseProjection:
    """One branch of a mixed layer. Subclasses declare their parameter
    specs in ``build(layer_name, idx)`` and compute in
    ``forward(params, value, ctx)``."""

    def __init__(self, input, size=None, param_attr=None):
        self.input = input
        self.size = size
        self.param_attr = param_attr
        self.specs = []

    def build(self, layer_name, idx):
        return []

    def forward(self, params, value, ctx):
        raise NotImplementedError


class full_matrix_projection(BaseProjection):
    """out = in @ W, W [in, size] (reference: FullMatrixProjection)."""

    def build(self, layer_name, idx):
        self.specs = [weight_spec(layer_name, idx,
                                  (self.input.size, self.size),
                                  self.param_attr, fan_in=self.input.size)]
        return self.specs

    def forward(self, params, value, ctx):
        w = params[self.specs[0].name]
        return featurewise(lambda d: torch.matmul(d, w), value)


class trans_full_matrix_projection(BaseProjection):
    """out = in @ W^T, W [size, in] (reference:
    TransposedFullMatrixProjection)."""

    def build(self, layer_name, idx):
        self.specs = [weight_spec(layer_name, idx,
                                  (self.size, self.input.size),
                                  self.param_attr, fan_in=self.input.size)]
        return self.specs

    def forward(self, params, value, ctx):
        w = params[self.specs[0].name]
        return featurewise(lambda d: torch.matmul(d, w.t()), value)


class identity_projection(BaseProjection):
    """The input unchanged, or ``size`` features from ``offset`` (reference:
    IdentityProjection / IdentityOffsetProjection)."""

    def __init__(self, input, offset=0, size=None):
        super().__init__(input, size or input.size - offset)
        self.offset = offset

    def forward(self, params, value, ctx):
        off, size = self.offset, self.size
        return featurewise(lambda d: d[..., off:off + size], value)


class table_projection(BaseProjection):
    """Rows of a [vocab, size] table for integer ids, clipped to the table
    (reference: TableProjection)."""

    def build(self, layer_name, idx):
        self.specs = [weight_spec(layer_name, idx,
                                  (self.input.size, self.size),
                                  self.param_attr, fan_in=self.size)]
        return self.specs

    def forward(self, params, value, ctx):
        table = params[self.specs[0].name]
        vocab = table.shape[0]
        return featurewise(
            lambda d: table[torch.clamp(d, 0, vocab - 1).long()], value)


class dotmul_projection(BaseProjection):
    """out = in * w, w a [size] vector (reference: DotMulProjection)."""

    def __init__(self, input, param_attr=None):
        super().__init__(input, input.size, param_attr)

    def build(self, layer_name, idx):
        self.specs = [weight_spec(layer_name, idx, (self.size,),
                                  self.param_attr, fan_in=1)]
        return self.specs

    def forward(self, params, value, ctx):
        w = params[self.specs[0].name]
        return featurewise(lambda d: d * w, value)


class scaling_projection(BaseProjection):
    """out = s * in, s a scalar parameter of shape (1,) (reference:
    ScalingProjection)."""

    def __init__(self, input, param_attr=None):
        super().__init__(input, input.size, param_attr)

    def build(self, layer_name, idx):
        self.specs = [weight_spec(layer_name, idx, (1,), self.param_attr,
                                  fan_in=1)]
        return self.specs

    def forward(self, params, value, ctx):
        w = params[self.specs[0].name]
        return featurewise(lambda d: d * w[0], value)


class context_projection(BaseProjection):
    """The sliding window of ``context_len`` steps from ``context_start``
    over a sequence, concatenated (reference: ContextProjection;
    ``ops.sequence.context_projection``). ``trainable_padding`` owns a
    [max(1, pad rows), in] table for the steps outside a sequence."""

    def __init__(self, input, context_start=-1, context_len=3,
                 trainable_padding=False, param_attr=None):
        super().__init__(input, input.size * context_len, param_attr)
        self.context_start = context_start
        self.context_len = context_len
        self.trainable_padding = trainable_padding

    def build(self, layer_name, idx):
        if self.trainable_padding:
            total_pad = max(0, -self.context_start) + max(
                0, self.context_start + self.context_len - 1)
            self.specs = [weight_spec(layer_name, idx,
                                      (max(total_pad, 1), self.input.size),
                                      self.param_attr,
                                      fan_in=self.input.size)]
        return self.specs

    def forward(self, params, value, ctx):
        enforce(is_seq(value), "context_projection expects a sequence")
        reject_packed(value, "context_projection")  # window spans segments
        padding = params[self.specs[0].name] if self.specs else None
        out = seq_ops.context_projection(value.data, value.mask(),
                                         self.context_start,
                                         self.context_len, padding)
        return SequenceBatch(out, value.lengths)


def _flat(nhwc):
    """NHWC -> the flat NCHW rows [B, C*H*W]."""
    b, h, w, c = nhwc.shape
    return nhwc.permute(0, 3, 1, 2).reshape(b, c * h * w)


class conv_projection(BaseProjection):
    """Convolution as a mixed-layer projection (reference:
    ConvProjection.cpp; DSL conv_projection): owns the HWIO filter
    ``(fh, fw, C/groups, F)``; the output is the flat NCHW feature map of
    ``F * oh * ow``. ``trans=True`` (the transposed conv) is not ported
    yet and raises, as ``img_conv(trans=True)`` does."""

    def __init__(self, input, filter_size, num_filters, num_channels=None,
                 stride=1, padding=0, groups=1, param_attr=None,
                 trans=False):
        from paddle_tpu_torch.layer.conv import conv_geometry

        enforce(not trans, "conv_projection(trans=True) is not ported yet")
        super().__init__(input, None, param_attr)
        (self.c, self.h, self.w, self.fh, self.fw, self.sh, self.sw,
         self.ph, self.pw, self.oh, self.ow) = conv_geometry(
            input, num_channels, filter_size, stride, padding)
        self.groups = groups
        self.num_filters = num_filters
        self.trans = trans
        self.size = num_filters * self.oh * self.ow

    def build(self, layer_name, idx):
        self.wspec = weight_spec(
            layer_name, idx,
            (self.fh, self.fw, self.c // self.groups, self.num_filters),
            self.param_attr, fan_in=self.c * self.fh * self.fw // self.groups)
        return [self.wspec]

    def forward(self, params, value, ctx):
        y = conv_ops.conv2d(as_nhwc(value, self.c, self.h, self.w),
                            params[self.wspec.name],
                            stride=(self.sh, self.sw),
                            padding=((self.ph, self.ph), (self.pw, self.pw)),
                            groups=self.groups)
        return like(value, _flat(y))


class conv_operator:
    """Parameter-free convolution of two layer outputs: ``img`` is the
    image, ``filter`` gives each sample its own filters, read as
    [F, C, fh, fw] (reference: ConvOperator.cpp; DSL conv_operator).
    ``trans=True`` is not ported yet and raises."""

    def __init__(self, img, filter, filter_size, num_filters,
                 num_channels=None, stride=1, padding=0, filter_size_y=None,
                 stride_y=None, padding_y=None, trans=False):
        from paddle_tpu_torch.layer.conv import conv_geometry

        enforce(not trans, "conv_operator(trans=True) is not ported yet")
        self.inputs = [img, filter]
        (self.c, self.h, self.w, self.fh, self.fw, self.sh, self.sw,
         self.ph, self.pw, self.oh, self.ow) = conv_geometry(
            img, num_channels, filter_size, stride, padding,
            filter_size_y, stride_y, padding_y)
        self.num_filters = num_filters
        self.trans = trans
        self.size = num_filters * self.oh * self.ow

    def forward_op(self, values, ctx):
        x = as_nhwc(values[0], self.c, self.h, self.w)
        # [B, F, C, fh, fw] -> HWIO per sample [B, fh, fw, C, F]
        filt = data_of(values[1]).reshape(
            -1, self.num_filters, self.c, self.fh, self.fw
        ).permute(0, 3, 4, 2, 1)
        stride = (self.sh, self.sw)
        padding = ((self.ph, self.ph), (self.pw, self.pw))
        y = torch.cat([conv_ops.conv2d(x[b:b + 1], filt[b].contiguous(),
                                       stride=stride, padding=padding)
                       for b in range(x.shape[0])])
        return like(values[0], _flat(y))


class dotmul_operator:
    """scale * a * b, elementwise (reference: DotMulOperator)."""

    def __init__(self, a, b, scale=1.0):
        self.inputs = [a, b]
        self.size = a.size
        self.scale = scale

    def forward_op(self, values, ctx):
        return like(values[0],
                    self.scale * data_of(values[0]) * data_of(values[1]))


@register_layer("mixed")
def mixed(size=None, input=None, name=None, act=None, bias_attr=False,
          layer_attr=None):
    """The sum of the projections and operators in ``input``, plus a bias
    and the activation (reference: MixedLayer.cpp; DSL mixed_layer). With
    ``input=None``, the v1 DSL's deferred form:

        with mixed_layer(size=100) as m:
            m += full_matrix_projection(input=x)

    (``MixedLayerContext``: ``+=`` collects the branches and the layer is
    built when the ``with`` block exits)."""
    if input is None:
        return MixedLayerContext(size=size, name=name, act=act,
                                 bias_attr=bias_attr, layer_attr=layer_attr)
    branches = to_list(input)
    enforce(len(branches) > 0, "mixed layer needs at least one projection")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("mixed")
    sizes = set()
    for br in branches:
        if isinstance(br, BaseProjection) and br.size is None:
            br.size = size
        sizes.add(br.size)
    enforce(len(sizes) == 1, "mixed branches disagree on size: %s", sizes)
    size = size or sizes.pop()

    specs, graph_inputs, branch_slots = [], [], []
    for i, br in enumerate(branches):
        if isinstance(br, BaseProjection):
            specs.extend(br.build(name, i))
            graph_inputs.append(br.input)
            branch_slots.append((br, [len(graph_inputs) - 1]))
        elif isinstance(br, (dotmul_operator, conv_operator)):
            slots = []
            for node_in in br.inputs:
                graph_inputs.append(node_in)
                slots.append(len(graph_inputs) - 1)
            branch_slots.append((br, slots))
        else:
            raise TypeError("mixed input must be projections/operators, "
                            "got %r" % (br,))
    bspec = bias_spec(name, (size,), bias_attr)
    if bspec is not None:
        specs.append(bspec)

    def forward(params, values, ctx):
        total = None
        for br, slots in branch_slots:
            if isinstance(br, BaseProjection):
                out = br.forward(params, values[slots[0]], ctx)
            else:
                out = br.forward_op([values[j] for j in slots], ctx)
            total = out if total is None else like(
                out, data_of(total) + data_of(out))
        if bspec is not None:
            total = like(total, data_of(total) + params[bspec.name])
        return finalize(total, act, node.extra_attr, ctx)

    node = make_node("mixed", forward, graph_inputs, name=name, size=size,
                     param_specs=specs, layer_attr=layer_attr)
    return mark_activation(node, act)


class MixedLayerContext(LayerNode):
    """The deferred mixed layer of the v1 DSL's ``with`` form: collects
    projections and operators through ``+=`` and becomes the mixed node
    when the block exits, so later layers consume it directly. It does
    not call ``LayerNode.__init__``: the node's state arrives whole from
    the finished ``mixed`` node."""

    def __init__(self, size=None, name=None, act=None, bias_attr=False,
                 layer_attr=None):
        self._pending = dict(size=size, name=name, act=act,
                             bias_attr=bias_attr, layer_attr=layer_attr)
        self._branches = []

    def __iadd__(self, branch):
        enforce("_pending" in self.__dict__,
                "mixed layer already finalized; += only works inside the "
                "with-block")
        self._branches.append(branch)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            p = self._pending
            node = mixed(size=p["size"], input=self._branches,
                         name=p["name"], act=p["act"],
                         bias_attr=p["bias_attr"],
                         layer_attr=p["layer_attr"])
            self.__dict__.clear()
            self.__dict__.update(vars(node))
        return False
