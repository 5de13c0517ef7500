"""Data (input) layers (reference: gserver/layers/DataLayer.h + v2
layer.data). A data layer is a typed graph leaf; its InputType drives feed
conversion (topology.convert_feed) and the serving manifest's inputs."""

from paddle_tpu_torch.data_type import InputType
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.layer.base import register_layer
from paddle_tpu_torch.utils.error import enforce


@register_layer("data")
def data(name, type, height=None, width=None, layer_attr=None):
    """``height``/``width`` declare the image geometry that conv and pool
    layers read (``out_img_shape`` = (C, H, W); paddle_tpu/layer/io.py)."""
    enforce(isinstance(type, InputType),
            "layer.data 'type' must be an InputType")

    def forward(params, inputs, ctx):
        return inputs[0]

    node = LayerNode("data", forward, inputs=(), name=name, size=type.dim,
                     seq_level=type.seq_type)
    node.input_type = type
    if height is not None or width is not None:
        enforce(height and width,
                "data %r: height and width must be given together and be "
                "positive (got height=%r width=%r)" % (name, height, width))
        channels = type.dim // (height * width)
        enforce(channels * height * width == type.dim,
                "data %r: size %d != C*%d*%d" % (name, type.dim, height,
                                                 width))
        node.out_img_shape = (channels, height, width)
    return node
