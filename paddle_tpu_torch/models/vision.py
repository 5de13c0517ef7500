"""Vision model topologies (paddle_tpu/models/vision.py)."""

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import pooling as pool


def mlp(img=None, num_classes=10, hidden=(128, 64)):
    """Simple MLP (reference: v1_api_demo/mnist simple mlp config;
    paddle_tpu/models/vision.py:26): 784 -> 128 -> 64 -> 10 with the JAX
    builder's names (mlp_fc0, mlp_fc1, mlp_out)."""
    if img is None:
        img = L.data(name="pixel", type=data_type.dense_vector(784))
    tmp = img
    for i, h in enumerate(hidden):
        tmp = L.fc(input=tmp, size=h, act=A.Relu(), name="mlp_fc%d" % i)
    return L.fc(input=tmp, size=num_classes, act=A.Softmax(), name="mlp_out")


def resnet(img=None, depth=50, num_classes=1000, im_size=224):
    """ResNet (reference: v1_api_demo/model_zoo/resnet/resnet.py;
    paddle_tpu/models/vision.py:137) -- basic blocks at depth 18 and 34,
    bottleneck blocks with batch norm at 50, 101 and 152. Layer and
    parameter names are the JAX builder's (res_stem_conv, res2_0_a_bn,
    res2_0_add, ..., res_gap, res_out); conv weights are HWIO, as there.

    At 224 the stem's 7x7/s2 conv gives 112x112 and the ceil-mode 3x3/s2
    pool 57x57; the stages run at 57, 29, 15 and 8. Every stride-1 conv
    (46 of ResNet-50's 53) is in the hand-written kernels' family."""
    if img is None:
        img = L.data(name="image",
                     type=data_type.dense_vector(3 * im_size * im_size))
    img.out_img_shape = (3, im_size, im_size)
    cfg = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
           50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
           152: ([3, 8, 36, 3], True)}
    blocks, bottleneck = cfg[depth]

    def conv_bn(name, ipt, filters, fsize, stride, padding, act):
        c = L.img_conv(input=ipt, filter_size=fsize, num_filters=filters,
                       stride=stride, padding=padding, act=None,
                       bias_attr=False, name=name + "_conv")
        return L.batch_norm(input=c, act=act, name=name + "_bn")

    def shortcut(name, ipt, out_ch, stride):
        if ipt.out_img_shape[0] != out_ch or stride != 1:
            return conv_bn(name + "_sc", ipt, out_ch, 1, stride, 0, None)
        return ipt

    def basic_block(name, ipt, ch, stride):
        sc = shortcut(name, ipt, ch, stride)
        t = conv_bn(name + "_a", ipt, ch, 3, stride, 1, A.Relu())
        t = conv_bn(name + "_b", t, ch, 3, 1, 1, None)
        out = L.addto(input=[t, sc], act=A.Relu(), name=name + "_add")
        out.out_img_shape = t.out_img_shape
        return out

    def bottleneck_block(name, ipt, ch, stride):
        sc = shortcut(name, ipt, ch * 4, stride)
        t = conv_bn(name + "_a", ipt, ch, 1, stride, 0, A.Relu())
        t = conv_bn(name + "_b", t, ch, 3, 1, 1, A.Relu())
        t = conv_bn(name + "_c", t, ch * 4, 1, 1, 0, None)
        out = L.addto(input=[t, sc], act=A.Relu(), name=name + "_add")
        out.out_img_shape = t.out_img_shape
        return out

    block = bottleneck_block if bottleneck else basic_block

    t = conv_bn("res_stem", img, 64, 7, 2, 3, A.Relu())
    t = L.img_pool(input=t, pool_size=3, stride=2, padding=1,
                   name="res_pool1")
    channels = [64, 128, 256, 512]
    for stage, (n, ch) in enumerate(zip(blocks, channels)):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            t = block("res%d_%d" % (stage + 2, i), t, ch, stride)
    c, h, w = t.out_img_shape
    t = L.img_pool(input=t, pool_size=h, stride=1,
                   pool_type=pool.AvgPooling(), name="res_gap")
    return L.fc(input=t, size=num_classes, act=A.Softmax(), name="res_out")
