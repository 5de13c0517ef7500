"""PTB-style LM n-grams (paddle_tpu/dataset/imikolov.py; parity:
python/paddle/v2/dataset/imikolov.py).
Schema: n-gram tuple of word ids (default), or (src_seq, trg_seq) id
lists in ``mode="seq"``.

Real files are parsed from the local cache (``simple-examples.tgz``,
the Mikolov PTB archive: ``simple-examples/data/ptb.train.txt`` /
``ptb.valid.txt``, one sentence per line) when present. Dict building
matches the reference: frequencies count over BOTH the train and valid
splits (reference: ``word_count(testf, word_count(trainf))``), every
line counts its tokens plus one ``<s>`` and one ``<e>``, any literal
``<unk>`` token is dropped, words with frequency strictly above
``min_word_freq`` are kept, sorted by (-freq, word) for dense ids, and
``<unk>`` is appended last. Readers
wrap each sentence as ``<s> ... <e>`` with OOV mapped to ``<unk>``,
then emit sliding n-gram tuples (``mode="ngram"``) or the whole
sentence as (current-words, next-words) id lists (``mode="seq"`` — the
reference's DataType.SEQ; its NATURAL length skew feeds the
length-bucketing tests, tests/test_data_pipeline.py). Without the
cache the synthetic generators reproduce both schemas, including a
skewed sentence-length distribution for seq mode.
"""

import collections
import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"

WORD_DICT_SIZE = 2000

TRAIN_MEMBER = "simple-examples/data/ptb.train.txt"
TEST_MEMBER = "simple-examples/data/ptb.valid.txt"


def _real_archive():
    path = common.data_path("imikolov", "simple-examples.tgz")
    return path if os.path.exists(path) else None


# parsed sentences per (archive path, member): reading a .tgz member
# gunzips the whole archive stream, and the readers re-run once per
# training pass — cache so each member decompresses ONCE per process
_lines_cache = {}


def _read_lines(path, suffix):
    key = (path, suffix)
    cached = _lines_cache.get(key)
    if cached is not None:
        return cached
    with tarfile.open(path) as tf:
        for member in tf.getmembers():
            if member.name.endswith(suffix):
                data = tf.extractfile(member).read().decode("utf-8")
                lines = [l for l in data.splitlines() if l.strip()]
                _lines_cache[key] = lines
                return lines
    raise IOError("%s has no member ending with %r" % (path, suffix))


def word_count(lines, word_freq=None):
    """Token counts over sentences, one ``<s>``/``<e>`` per line
    (reference: imikolov.word_count)."""
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in lines:
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict(min_word_freq=50):
    """Word -> id dict. Real path: reference semantics over the train
    split (see module docstring); fallback: the synthetic dict."""
    path = _real_archive()
    if path is None:
        return {"w%d" % i: i for i in range(WORD_DICT_SIZE)}
    # reference counts BOTH splits: word_count(testf, word_count(trainf))
    word_freq = word_count(_read_lines(path, TEST_MEMBER),
                           word_count(_read_lines(path, TRAIN_MEMBER)))
    word_freq.pop("<unk>", None)
    kept = [x for x in word_freq.items() if x[1] > min_word_freq]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(path, member, word_idx, n, mode):
    unk = word_idx["<unk>"]

    def reader():
        for line in _read_lines(path, member):
            words = ["<s>"] + line.strip().split() + ["<e>"]
            ids = [word_idx.get(w, unk) for w in words]
            if mode == "ngram":
                if len(ids) >= n:
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            else:  # seq: (current words, next words), LM teacher forcing
                if len(ids) < 2:
                    continue
                yield ids[:-1], ids[1:]

    return reader


def _synthetic(word_idx, n, num, seed, mode="ngram"):
    size = len(word_idx)

    def reader():
        local = np.random.RandomState(seed)
        if mode == "ngram":
            for _ in range(num):
                # markov-ish: next word biased near previous
                first = local.randint(0, size)
                gram = [first]
                for _ in range(n - 1):
                    gram.append((gram[-1] + local.randint(0, 20)) % size)
                yield tuple(gram)
            return
        for _ in range(num):
            # sentence lengths with REALISTIC skew (mostly short, a long
            # tail), the shape length bucketing exists for
            length = 2 + min(int(local.lognormal(mean=2.0, sigma=0.7)), 78)
            sent = [local.randint(0, size)]
            for _ in range(length - 1):
                sent.append((sent[-1] + local.randint(0, 20)) % size)
            yield sent[:-1], sent[1:]

    return reader


def train(word_idx, n, synthetic_size=4096, mode="ngram"):
    path = _real_archive()
    if path is not None:
        return _real_reader(path, TRAIN_MEMBER, word_idx, n, mode)
    return _synthetic(word_idx, n, synthetic_size, seed=0, mode=mode)


def test(word_idx, n, synthetic_size=512, mode="ngram"):
    path = _real_archive()
    if path is not None:
        return _real_reader(path, TEST_MEMBER, word_idx, n, mode)
    return _synthetic(word_idx, n, synthetic_size, seed=9, mode=mode)


def fetch():
    """Download simple-examples.tgz into the dataset cache (no-egress
    environments: place it there manually, or rely on the synthetic
    fallback)."""
    return common.download(URL, "imikolov", MD5)
