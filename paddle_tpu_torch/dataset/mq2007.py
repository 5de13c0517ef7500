"""MQ2007 learning-to-rank (paddle_tpu/dataset/mq2007.py; parity:
python/paddle/v2/dataset/mq2007.py).
Schema pairwise: ((feature_a, feature_b), label); listwise: (query features
list, relevance list)."""

import numpy as np

from paddle_tpu_torch.dataset import common

FEATURE_DIM = 46


def _synthetic_list(n_queries, seed, docs_per_query=(5, 20)):
    rng = common.synthetic_rng("mq2007", seed)
    true_w = rng.randn(FEATURE_DIM).astype(np.float32)

    def reader():
        local = np.random.RandomState(seed + 1)
        for _ in range(n_queries):
            n_docs = local.randint(*docs_per_query)
            feats = local.randn(n_docs, FEATURE_DIM).astype(np.float32)
            scores = feats @ true_w
            rel = np.digitize(scores, np.quantile(scores, [0.5, 0.8]))
            yield feats, rel.astype(np.float32).reshape(-1, 1)

    return reader


def train_listwise(synthetic_size=512):
    return _synthetic_list(synthetic_size, seed=0)


def test_listwise(synthetic_size=64):
    return _synthetic_list(synthetic_size, seed=5)


def _pairwise_from_list(list_reader):
    def reader():
        for feats, rel in list_reader():
            rel = rel.reshape(-1)
            order = np.argsort(-rel)
            for i in range(len(order) - 1):
                a, b = order[i], order[i + 1]
                if rel[a] > rel[b]:
                    yield feats[a], feats[b], 1.0

    return reader


def train(synthetic_size=512):
    return _pairwise_from_list(train_listwise(synthetic_size))


def test(synthetic_size=64):
    return _pairwise_from_list(test_listwise(synthetic_size))
