"""Oxford 102 Flowers (paddle_tpu/dataset/flowers.py; parity:
python/paddle/v2/dataset/flowers.py).
Schema: (image: float32[3*H*W] in [0,1], label int in [0, 102)).

The readers serve deterministic synthetic data with the real schema
(common.synthetic_rng); the URLs are the reference's."""

import numpy as np

from paddle_tpu_torch.dataset import common

NUM_CLASSES = 102
DEFAULT_SIZE = 32  # synthetic images are HxW=32x32 (real set is resized 224)

DATA_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"
LABEL_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/imagelabels.mat"


def _synthetic(n, seed, image_size):
    dim = 3 * image_size * image_size
    rng = common.synthetic_rng("flowers", seed)
    prototypes = rng.rand(NUM_CLASSES, dim).astype(np.float32)

    def reader():
        local = np.random.RandomState(seed + 1)
        for i in range(n):
            label = i % NUM_CLASSES
            img = 0.7 * prototypes[label] + 0.3 * local.rand(dim)
            yield img.astype(np.float32), label

    return reader


def train(synthetic_size=2048, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=0, image_size=image_size)


def test(synthetic_size=256, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=7, image_size=image_size)


def valid(synthetic_size=256, image_size=DEFAULT_SIZE):
    return _synthetic(synthetic_size, seed=11, image_size=image_size)
