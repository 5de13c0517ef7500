"""IMDB sentiment (paddle_tpu/dataset/imdb.py; parity:
python/paddle/v2/dataset/imdb.py).

Schema: (word id sequence, label 0=pos / 1=neg). Real parse path
(reference imdb.py:37-77): stream ``aclImdb_v1.tar.gz`` from the local
cache, tokenize each review (punctuation stripped, lowercased,
whitespace split), build the frequency-sorted word dict with a cutoff
and trailing ``<unk>``. Synthetic fallback keeps the same schema for
hermetic runs. Used by the RNN benchmark (reference: benchmark/paddle/rnn).
"""

import os
import re
import string
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

WORD_DICT_SIZE = 30000

ARCHIVE = "aclImdb_v1.tar.gz"
_TRAIN_POS = re.compile(r"aclImdb/train/pos/.*\.txt$")
_TRAIN_NEG = re.compile(r"aclImdb/train/neg/.*\.txt$")
_TEST_POS = re.compile(r"aclImdb/test/pos/.*\.txt$")
_TEST_NEG = re.compile(r"aclImdb/test/neg/.*\.txt$")
_DICT_PATTERN = re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
_PUNCT = str.maketrans("", "", string.punctuation)


def _archive_path():
    return common.data_path("imdb", ARCHIVE)


def tokenize(pattern, path=None):
    """Yield one token list per archive member matching ``pattern``
    (reference imdb.py tokenize: sequential tar scan, punctuation
    removal, lowercase, whitespace split)."""
    path = path or _archive_path()
    with tarfile.open(path) as tarf:
        member = tarf.next()
        while member is not None:
            if pattern.match(member.name):
                text = tarf.extractfile(member).read().decode(
                    "utf-8", "ignore")
                yield text.rstrip("\n\r").translate(_PUNCT).lower().split()
            member = tarf.next()


def build_dict(pattern=_DICT_PATTERN, cutoff=150, path=None):
    """Frequency-sorted word dict (ties broken lexically) with words at
    or below ``cutoff`` occurrences dropped and '<unk>' appended
    (reference imdb.py build_dict)."""
    freq = {}
    for doc in tokenize(pattern, path=path):
        for word in doc:
            freq[word] = freq.get(word, 0) + 1
    kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                  key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(pos_pattern, neg_pattern, word_idx, path):
    """Alternate pos (label 0) / neg (label 1) docs, reference label
    convention (imdb.py reader_creator: queue index is the label)."""
    unk = word_idx["<unk>"]

    def reader():
        pos = tokenize(pos_pattern, path=path)
        neg = tokenize(neg_pattern, path=path)
        streams = [pos, neg]
        i = 0
        live = [True, True]
        while any(live):
            if live[i % 2]:
                try:
                    doc = next(streams[i % 2])
                    yield [word_idx.get(w, unk) for w in doc], i % 2
                except StopIteration:
                    live[i % 2] = False
            i += 1

    return reader


def word_dict(size=WORD_DICT_SIZE, cutoff=150):
    """Real corpus dict when the archive is cached (reference
    word_dict(): build_dict over train+test with cutoff 150), else the
    synthetic id-named dict. ``size`` caps the dict either way — callers
    size embedding tables with it (demos/quick_start), so every id this
    module ever yields must stay below it: the real dict keeps the
    ``size - 1`` most frequent words and remaps '<unk>' to size - 1."""
    if os.path.exists(_archive_path()):
        full = build_dict(cutoff=cutoff)
        if len(full) <= size:
            return full
        kept = sorted((w for w in full if w != "<unk>"),
                      key=full.get)[:size - 1]
        capped = {w: i for i, w in enumerate(kept)}
        capped["<unk>"] = len(capped)
        return capped
    return {"w%d" % i: i for i in range(size)}


def _synthetic(n, seed, dict_size, min_len=20, max_len=100):
    """Sentiment-separable synthetic text: positive docs oversample one
    vocabulary band, negative the other."""
    def reader():
        local = np.random.RandomState(seed)
        for i in range(n):
            label = i % 2
            length = local.randint(min_len, max_len + 1)
            if label:
                ids = local.randint(0, dict_size // 2, size=length)
            else:
                ids = local.randint(dict_size // 2, dict_size, size=length)
            yield ids.astype(np.int32), label

    return reader


def train(word_idx=None, synthetic_size=2048):
    path = _archive_path()
    if os.path.exists(path):
        return _real_reader(_TRAIN_POS, _TRAIN_NEG,
                            word_idx or word_dict(), path)
    size = len(word_idx) if word_idx else WORD_DICT_SIZE
    return _synthetic(synthetic_size, 0, size)


def test(word_idx=None, synthetic_size=512):
    path = _archive_path()
    if os.path.exists(path):
        return _real_reader(_TEST_POS, _TEST_NEG,
                            word_idx or word_dict(), path)
    size = len(word_idx) if word_idx else WORD_DICT_SIZE
    return _synthetic(synthetic_size, 3, size)
