"""Vision model topologies (paddle_tpu/models/vision.py), with the JAX
builders' layer and parameter names and geometry."""

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import pooling as pool


def lenet(img=None, num_classes=10):
    """LeNet-5-style MNIST conv net (reference: v1_api_demo/mnist
    mnist_conv_group; paddle_tpu/models/vision.py:10)."""
    if img is None:
        img = L.data(name="pixel", type=data_type.dense_vector(784))
    img.out_img_shape = (1, 28, 28)
    conv1 = L.img_conv(input=img, filter_size=5, num_filters=20, padding=0,
                       act=A.Relu(), name="lenet_conv1")
    pool1 = L.img_pool(input=conv1, pool_size=2, stride=2, name="lenet_pool1")
    conv2 = L.img_conv(input=pool1, filter_size=5, num_filters=50, padding=0,
                       act=A.Relu(), name="lenet_conv2")
    pool2 = L.img_pool(input=conv2, pool_size=2, stride=2, name="lenet_pool2")
    fc1 = L.fc(input=pool2, size=500, act=A.Relu(), name="lenet_fc1")
    return L.fc(input=fc1, size=num_classes, act=A.Softmax(), name="lenet_out")


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


def smallnet_cifar(img=None, num_classes=10):
    """cifar 'smallnet' quick model (reference: benchmark/paddle/image
    smallnet_mnist_cifar.py; paddle_tpu/models/vision.py:37): three 5x5
    convs (F.conv2d) and 3x3/s2 ceil-mode pools, then two fc layers."""
    if img is None:
        img = L.data(name="image", type=data_type.dense_vector(3072))
    img.out_img_shape = (3, 32, 32)
    t = L.img_conv(input=img, filter_size=5, num_filters=32, padding=2,
                   act=A.Relu(), name="small_conv1")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="small_pool1")
    t = L.img_conv(input=t, filter_size=5, num_filters=32, padding=2,
                   act=A.Relu(), name="small_conv2")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="small_pool2")
    t = L.img_conv(input=t, filter_size=5, num_filters=64, padding=2,
                   act=A.Relu(), name="small_conv3")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="small_pool3")
    t = L.fc(input=t, size=64, act=A.Relu(), name="small_fc1")
    return L.fc(input=t, size=num_classes, act=A.Softmax(), name="small_out")


def alexnet(img=None, num_classes=1000):
    """AlexNet (reference: benchmark/paddle/image/alexnet.py;
    paddle_tpu/models/vision.py:56) at 227x227: conv1 11x11/s4 and conv2
    5x5 run F.conv2d, conv3-5 (3x3 at 13x13) the hand-written kernels;
    two cross-map norms, 6x6x256 before alex_fc6, dropout 0.5 after fc6
    and fc7."""
    if img is None:
        img = L.data(name="image", type=data_type.dense_vector(3 * 227 * 227))
    img.out_img_shape = (3, 227, 227)
    t = L.img_conv(input=img, filter_size=11, num_filters=96, stride=4,
                   act=A.Relu(), name="alex_conv1")
    t = L.img_cmrnorm(input=t, size=5, name="alex_norm1")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="alex_pool1")
    t = L.img_conv(input=t, filter_size=5, num_filters=256, padding=2,
                   groups=1, act=A.Relu(), name="alex_conv2")
    t = L.img_cmrnorm(input=t, size=5, name="alex_norm2")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="alex_pool2")
    t = L.img_conv(input=t, filter_size=3, num_filters=384, padding=1,
                   act=A.Relu(), name="alex_conv3")
    t = L.img_conv(input=t, filter_size=3, num_filters=384, padding=1,
                   act=A.Relu(), name="alex_conv4")
    t = L.img_conv(input=t, filter_size=3, num_filters=256, padding=1,
                   act=A.Relu(), name="alex_conv5")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="alex_pool5")
    t = L.fc(input=t, size=4096, act=A.Relu(), name="alex_fc6")
    t = L.dropout(input=t, dropout_rate=0.5)
    t = L.fc(input=t, size=4096, act=A.Relu(), name="alex_fc7")
    t = L.dropout(input=t, dropout_rate=0.5)
    return L.fc(input=t, size=num_classes, act=A.Softmax(), name="alex_fc8")


def googlenet(img=None, num_classes=1000):
    """GoogleNet-v1 (reference: benchmark/paddle/image/googlenet.py;
    paddle_tpu/models/vision.py:86) at 224x224: nine inception blocks,
    each a channel concat of four towers. Its 47 1x1 and 3x3 stride-1
    convs run the hand-written kernels; the 7x7/s2 stem and the nine 5x5
    convs run F.conv2d. 7x7x1024 before goog_pool5, dropout 0.4 before
    goog_out."""
    if img is None:
        img = L.data(name="image", type=data_type.dense_vector(3 * 224 * 224))
    img.out_img_shape = (3, 224, 224)

    def inception(name, ipt, num_1x1, num_3x3r, num_3x3, num_5x5r, num_5x5,
                  num_pool_proj):
        b1 = L.img_conv(input=ipt, filter_size=1, num_filters=num_1x1,
                        act=A.Relu(), name=name + "_1x1")
        b2 = L.img_conv(input=ipt, filter_size=1, num_filters=num_3x3r,
                        act=A.Relu(), name=name + "_3x3r")
        b2 = L.img_conv(input=b2, filter_size=3, num_filters=num_3x3,
                        padding=1, act=A.Relu(), name=name + "_3x3")
        b3 = L.img_conv(input=ipt, filter_size=1, num_filters=num_5x5r,
                        act=A.Relu(), name=name + "_5x5r")
        b3 = L.img_conv(input=b3, filter_size=5, num_filters=num_5x5,
                        padding=2, act=A.Relu(), name=name + "_5x5")
        b4 = L.img_pool(input=ipt, pool_size=3, stride=1, padding=1,
                        name=name + "_poolproj_pool")
        b4 = L.img_conv(input=b4, filter_size=1, num_filters=num_pool_proj,
                        act=A.Relu(), name=name + "_poolproj")
        out = L.concat(input=[b1, b2, b3, b4], name=name + "_concat")
        c, h, w = b1.out_img_shape
        total_c = num_1x1 + num_3x3 + num_5x5 + num_pool_proj
        out.out_img_shape = (total_c, h, w)
        return out

    t = L.img_conv(input=img, filter_size=7, num_filters=64, stride=2,
                   padding=3, act=A.Relu(), name="goog_conv1")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="goog_pool1")
    t = L.img_conv(input=t, filter_size=1, num_filters=64, act=A.Relu(),
                   name="goog_conv2r")
    t = L.img_conv(input=t, filter_size=3, num_filters=192, padding=1,
                   act=A.Relu(), name="goog_conv2")
    t = L.img_pool(input=t, pool_size=3, stride=2, name="goog_pool2")
    t = inception("goog_3a", t, 64, 96, 128, 16, 32, 32)
    t = inception("goog_3b", t, 128, 128, 192, 32, 96, 64)
    t = L.img_pool(input=t, pool_size=3, stride=2, name="goog_pool3")
    t = inception("goog_4a", t, 192, 96, 208, 16, 48, 64)
    t = inception("goog_4b", t, 160, 112, 224, 24, 64, 64)
    t = inception("goog_4c", t, 128, 128, 256, 24, 64, 64)
    t = inception("goog_4d", t, 112, 144, 288, 32, 64, 64)
    t = inception("goog_4e", t, 256, 160, 320, 32, 128, 128)
    t = L.img_pool(input=t, pool_size=3, stride=2, name="goog_pool4")
    t = inception("goog_5a", t, 256, 160, 320, 32, 128, 128)
    t = inception("goog_5b", t, 384, 192, 384, 48, 128, 128)
    c, h, w = t.out_img_shape
    t = L.img_pool(input=t, pool_size=h, stride=1,
                   pool_type=pool.AvgPooling(), name="goog_pool5")
    t = L.dropout(input=t, dropout_rate=0.4)
    return L.fc(input=t, size=num_classes, act=A.Softmax(), name="goog_out")


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
