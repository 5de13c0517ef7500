"""WMT-14 FR-EN translation pairs (paddle_tpu/dataset/wmt14.py; parity:
python/paddle/v2/dataset/wmt14.py).

Schema: (source ids, target ids with <s>, target ids with <e>). Real
parse path (reference wmt14.py:55-99): the shrunk-data tarball carries
``src.dict``/``trg.dict`` (one token per line, first ``dict_size``
kept) and train/test files of tab-separated sentence pairs; sequences
wrap with <s>/<e>, unknown words map to UNK_IDX=2, and pairs longer
than 80 tokens are dropped. Synthetic fallback keeps the schema: its
ids run up to SOURCE_DICT_SIZE / TARGET_DICT_SIZE whatever ``dict_size``
says, as the JAX package's do (a model sized below 30000 words needs the
real archive or ``dict_size=30000``).
"""

import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

SOURCE_DICT_SIZE = 30000
TARGET_DICT_SIZE = 30000
START = 0
END = 1
UNK = 2
START_TOKEN = "<s>"
END_TOKEN = "<e>"
UNK_TOKEN = "<unk>"

ARCHIVE = "wmt14.tgz"
MAX_LEN = 80


def _archive_path():
    return common.data_path("wmt14", ARCHIVE)


def _read_dicts(tar_path, dict_size):
    """First ``dict_size`` lines of the archive's src.dict/trg.dict
    (reference __read_to_dict__)."""
    def to_dict(fd, size):
        out = {}
        for count, line in enumerate(fd):
            if count >= size:
                break
            out[line.decode("utf-8").strip()] = count
        return out

    with tarfile.open(tar_path, mode="r") as f:
        src_name = [m.name for m in f if m.name.endswith("src.dict")]
        trg_name = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1
        src_dict = to_dict(f.extractfile(src_name[0]), dict_size)
        trg_dict = to_dict(f.extractfile(trg_name[0]), dict_size)
    return src_dict, trg_dict


def _real_reader(tar_path, file_suffix, dict_size):
    """Reference reader_creator: members ending with ``file_suffix``,
    one tab-separated pair per line."""
    # dicts parse ONCE at creator time (reference reader_creator parity);
    # each pass re-reads only the pair data
    src_dict, trg_dict = _read_dicts(tar_path, dict_size)

    def reader():
        with tarfile.open(tar_path, mode="r") as f:
            names = [m.name for m in f if m.name.endswith(file_suffix)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, UNK) for w in
                               [START_TOKEN] + src_words + [END_TOKEN]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK) for w in trg_words]
                    if len(src_ids) > MAX_LEN or len(trg_ids) > MAX_LEN:
                        continue
                    trg_next = trg_ids + [trg_dict[END_TOKEN]]
                    trg_ids = [trg_dict[START_TOKEN]] + trg_ids
                    yield (np.asarray(src_ids, np.int32),
                           np.asarray(trg_ids, np.int32),
                           np.asarray(trg_next, np.int32))

    return reader


def _synthetic(n, seed, min_len=4, max_len=30):
    def reader():
        local = np.random.RandomState(seed)
        for _ in range(n):
            length = local.randint(min_len, max_len + 1)
            src = local.randint(3, SOURCE_DICT_SIZE,
                                size=length).astype(np.int32)
            # target = reversed source band-mapped (deterministic, learnable)
            tgt = ((src[::-1] * 7) % (TARGET_DICT_SIZE - 3) + 3).astype(
                np.int32)
            trg_with_start = np.concatenate([[START], tgt]).astype(np.int32)
            trg_with_end = np.concatenate([tgt, [END]]).astype(np.int32)
            yield src, trg_with_start, trg_with_end

    return reader


def train(dict_size=SOURCE_DICT_SIZE, synthetic_size=2048):
    path = _archive_path()
    if os.path.exists(path):
        return _real_reader(path, "train/train", dict_size)
    return _synthetic(synthetic_size, seed=0)


def test(dict_size=SOURCE_DICT_SIZE, synthetic_size=256):
    path = _archive_path()
    if os.path.exists(path):
        return _real_reader(path, "test/test", dict_size)
    return _synthetic(synthetic_size, seed=21)
