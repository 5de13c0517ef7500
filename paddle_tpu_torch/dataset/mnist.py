"""MNIST dataset (paddle_tpu/dataset/mnist.py; parity:
python/paddle/v2/dataset/mnist.py).

Schema: (image: float32[784] scaled to [-1, 1], label: int in [0, 10)).
Real files are read from the local cache (idx format) when present;
otherwise the synthetic generator produces class-separable digits with the
same schema, adequate for convergence smoke tests and benchmarks.
"""

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.dataset import common

IMAGE_DIM = 784
NUM_CLASSES = 10


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32) / 255.0 * 2.0 - 1.0


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int64)


def _reader_from_files(image_path, label_path):
    def reader():
        images = _read_idx_images(image_path)
        labels = _read_idx_labels(label_path)
        for img, lab in zip(images, labels):
            yield img, int(lab)

    return reader


def _synthetic(n, seed):
    """Class-separable synthetic digits: each class is a fixed random
    prototype + noise (deterministic)."""
    rng = common.synthetic_rng("mnist", seed)
    prototypes = rng.randn(NUM_CLASSES, IMAGE_DIM).astype(np.float32)

    def reader():
        local = np.random.RandomState(seed + 1)
        for i in range(n):
            label = i % NUM_CLASSES
            img = prototypes[label] * 0.5 + local.randn(IMAGE_DIM).astype(np.float32) * 0.3
            yield np.clip(img, -1.0, 1.0).astype(np.float32), label

    return reader


def train(synthetic_size=8192):
    tr_img = common.data_path("mnist", "train-images-idx3-ubyte.gz")
    tr_lab = common.data_path("mnist", "train-labels-idx1-ubyte.gz")
    if os.path.exists(tr_img) and os.path.exists(tr_lab):
        return _reader_from_files(tr_img, tr_lab)
    return _synthetic(synthetic_size, seed=0)


def test(synthetic_size=1024):
    te_img = common.data_path("mnist", "t10k-images-idx3-ubyte.gz")
    te_lab = common.data_path("mnist", "t10k-labels-idx1-ubyte.gz")
    if os.path.exists(te_img) and os.path.exists(te_lab):
        return _reader_from_files(te_img, te_lab)
    return _synthetic(synthetic_size, seed=99)
