"""PASCAL VOC2012 segmentation (paddle_tpu/dataset/voc2012.py; parity:
python/paddle/v2/dataset/voc2012.py).
Schema: (image: float32[3*H*W] in [0,1], segmentation: int32[H*W] class ids
in [0, 21)).

The readers serve synthetic data with the real schema; the URL is the
reference's."""

import numpy as np

from paddle_tpu_torch.dataset import common

NUM_CLASSES = 21
DEFAULT_SIZE = 32

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")


def _synthetic(n, seed, image_size):
    dim = 3 * image_size * image_size

    def reader():
        local = np.random.RandomState(seed)
        for _ in range(n):
            img = local.rand(dim).astype(np.float32)
            # blocky synthetic segmentation: quadrant labels
            seg = np.zeros((image_size, image_size), np.int32)
            half = image_size // 2
            seg[:half, :half] = local.randint(0, NUM_CLASSES)
            seg[:half, half:] = local.randint(0, NUM_CLASSES)
            seg[half:, :half] = local.randint(0, NUM_CLASSES)
            seg[half:, half:] = local.randint(0, NUM_CLASSES)
            yield img, seg.reshape(-1)

    return reader


def train(synthetic_size=1024, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=0, image_size=image_size)


def test(synthetic_size=128, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=7, image_size=image_size)


def val(synthetic_size=128, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=11, image_size=image_size)
