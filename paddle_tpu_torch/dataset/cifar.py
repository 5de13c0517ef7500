"""CIFAR-10/100 (paddle_tpu/dataset/cifar.py; parity:
python/paddle/v2/dataset/cifar.py).

Schema: (image: float32[3072] in [0,1], label int). Real parse path
(reference cifar.py:46-61): the python-version tarballs hold pickled
batch dicts with ``data`` (N x 3072 uint8, CHW-flattened) and
``labels``/``fine_labels``; members are selected by substring
('data_batch'/'train' vs 'test'). Synthetic fallback keeps the schema.
"""

import os
import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

IMAGE_DIM = 3 * 32 * 32

CIFAR10_ARCHIVE = "cifar-10-python.tar.gz"
CIFAR100_ARCHIVE = "cifar-100-python.tar.gz"


def _real_reader(path, sub_name):
    """Reference reader_creator: iterate tar members whose name contains
    ``sub_name``, unpickle each batch, yield (pixels/255, label)."""
    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            for name in names:
                # py2-written pickles: latin1 maps bytes 1:1
                batch = pickle.load(f.extractfile(name), encoding="latin1")
                data = batch.get("data", batch.get(b"data"))
                labels = batch.get("labels", batch.get("fine_labels"))
                if labels is None:
                    labels = batch.get(b"labels", batch.get(b"fine_labels"))
                assert labels is not None, "no labels in %s" % name
                for sample, label in zip(data, labels):
                    yield (np.asarray(sample, np.float32) / 255.0,
                           int(label))

    return reader


def _synthetic(n, num_classes, seed):
    rng = common.synthetic_rng("cifar%d" % num_classes, seed)
    prototypes = rng.rand(num_classes, IMAGE_DIM).astype(np.float32)

    def reader():
        local = np.random.RandomState(seed + 1)
        for i in range(n):
            label = i % num_classes
            img = 0.6 * prototypes[label] + 0.4 * local.rand(IMAGE_DIM)
            yield img.astype(np.float32), label

    return reader


def _maybe_real(archive, sub_name, synthetic):
    path = common.data_path("cifar", archive)
    if os.path.exists(path):
        return _real_reader(path, sub_name)
    return synthetic


def train10(synthetic_size=4096):
    return _maybe_real(CIFAR10_ARCHIVE, "data_batch",
                       _synthetic(synthetic_size, 10, seed=0))


def test10(synthetic_size=512):
    return _maybe_real(CIFAR10_ARCHIVE, "test_batch",
                       _synthetic(synthetic_size, 10, seed=7))


def train100(synthetic_size=4096):
    return _maybe_real(CIFAR100_ARCHIVE, "train",
                       _synthetic(synthetic_size, 100, seed=0))


def test100(synthetic_size=512):
    return _maybe_real(CIFAR100_ARCHIVE, "test",
                       _synthetic(synthetic_size, 100, seed=7))
