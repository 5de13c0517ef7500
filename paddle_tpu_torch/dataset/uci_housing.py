"""UCI housing regression (paddle_tpu/dataset/uci_housing.py; parity:
python/paddle/v2/dataset/uci_housing.py).
Schema: (features: float32[13] normalized, price: float32[1]).

Real files are read from the local cache (``housing.data``, the UCI
whitespace-separated 14-column format) when present — same parse +
normalization as the reference: per-feature ``(x - avg) / (max - min)``
over the WHOLE file, then an 80/20 train/test split in file order
(reference load_data :74). Otherwise the synthetic generator produces a
linear-regression problem with the same schema. The real path feeds the
exported dense-regression demo bundle (demos/fit_a_line/train.py).
"""

import os

import numpy as np

from paddle_tpu_torch.dataset import common

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
MD5 = "d4accdce7a25600298819f8e28e8d593"

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]
FEATURE_DIM = 13
TRAIN_RATIO = 0.8


def load_data(path, feature_num=FEATURE_DIM + 1, ratio=TRAIN_RATIO):
    """Parse + normalize the real housing.data file; returns
    (train_rows, test_rows) float32 arrays of [n, 14] (13 normalized
    features + raw price). Reference: v2 uci_housing.load_data — stats
    computed over the full file BEFORE the split, features scaled by
    (x - avg) / (max - min), price column untouched."""
    data = np.fromfile(path, sep=" ", dtype=np.float64)
    if data.size == 0 or data.size % feature_num != 0:
        raise ValueError(
            "%s is not %d whitespace-separated columns (got %d values)"
            % (path, feature_num, data.size))
    data = data.reshape(data.size // feature_num, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(feature_num - 1):
        span = maximums[i] - minimums[i]
        if span == 0:
            span = 1.0  # constant column: centered to 0, not inf
        data[:, i] = (data[:, i] - avgs[i]) / span
    offset = int(data.shape[0] * ratio)
    return (data[:offset].astype(np.float32),
            data[offset:].astype(np.float32))


def _real_path():
    path = common.data_path("uci_housing", "housing.data")
    return path if os.path.exists(path) else None


def _reader_from_rows(rows):
    def reader():
        for row in rows:
            yield row[:-1], row[-1:]

    return reader


def _synthetic(n, seed):
    rng = common.synthetic_rng("uci_housing", seed)
    true_w = rng.randn(FEATURE_DIM).astype(np.float32)

    def reader():
        local = np.random.RandomState(seed + 1)
        for _ in range(n):
            x = local.randn(FEATURE_DIM).astype(np.float32)
            y = float(x @ true_w + 0.1 * local.randn())
            yield x, np.array([y], np.float32)

    return reader


def train(synthetic_size=404):
    path = _real_path()
    if path is not None:
        return _reader_from_rows(load_data(path)[0])
    return _synthetic(synthetic_size, seed=0)


def test(synthetic_size=102):
    path = _real_path()
    if path is not None:
        return _reader_from_rows(load_data(path)[1])
    return _synthetic(synthetic_size, seed=5)


def fetch():
    """Download the real file into the dataset cache (no-egress
    environments: place housing.data there manually, or rely on the
    synthetic fallback)."""
    return common.download(URL, "uci_housing", MD5)
