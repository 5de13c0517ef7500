"""CoNLL-05 semantic role labeling (paddle_tpu/dataset/conll05.py; parity:
python/paddle/v2/dataset/conll05.py).

Real parse path (reference conll05.py:44-126): the public test tarball
holds gzipped ``words``/``props`` column files; sentences are split on
blank prop lines, each predicate column expands bracket notation
('(A0*', '*', '*)') into B-/I-/O tags, and ``reader_creator`` derives
the 9-slot sample (word ids, 5 predicate-context id seqs, predicate id,
mark flags, label id seq). Dicts load from the reference's
wordDict/verbDict/targetDict text files (one token per line). The
simplified 2-tuple readers (``train``/``test`` -> (word ids, label
ids)) feed the sequence-tagging demo; the full 9-slot reader is
``test_full``. Synthetic fallback keeps the 2-tuple schema.
"""

import gzip
import itertools
import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

WORD_DICT_SIZE = 5000
LABEL_DICT_SIZE = 67
PRED_DICT_SIZE = 300
UNK_IDX = 0

ARCHIVE = "conll05st-tests.tar.gz"
WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"
DICT_FILES = ("wordDict.txt", "verbDict.txt", "targetDict.txt")


def load_dict(filename):
    """token -> zero-based line number (reference load_dict)."""
    d = {}
    with open(filename, "r") as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _expand_props(labels):
    """Expand one predicate's bracket column into B-/I-/O tags
    (reference corpus_reader inner loop)."""
    cur_tag, in_bracket = "O", False
    seq = []
    for l in labels:
        if l == "*" and not in_bracket:
            seq.append("O")
        elif l == "*" and in_bracket:
            seq.append("I-" + cur_tag)
        elif l == "*)":
            seq.append("I-" + cur_tag)
            in_bracket = False
        elif "(" in l and ")" in l:
            cur_tag = l[1:l.find("*")]
            seq.append("B-" + cur_tag)
            in_bracket = False
        elif "(" in l and ")" not in l:
            cur_tag = l[1:l.find("*")]
            seq.append("B-" + cur_tag)
            in_bracket = True
        else:
            raise RuntimeError("Unexpected label: %s" % l)
    return seq


def corpus_reader(data_path, words_name=WORDS_NAME, props_name=PROPS_NAME):
    """Yield (sentence words, predicate word, B/I/O label seq) per
    predicate per sentence from the raw corpus tarball."""
    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentence, one_seg = [], []
                for word, prop in itertools.zip_longest(words_file,
                                                        props_file):
                    word = (word or b"").decode("utf-8").strip()
                    cols = (prop or b"").decode("utf-8").strip().split()
                    if not cols:  # blank line = end of sentence
                        if one_seg:
                            columns = [[row[i] for row in one_seg]
                                       for i in range(len(one_seg[0]))]
                            verbs = [v for v in columns[0] if v != "-"]
                            for i, lbl in enumerate(columns[1:]):
                                yield sentence, verbs[i], _expand_props(lbl)
                        sentence, one_seg = [], []
                    else:
                        sentence.append(word)
                        one_seg.append(cols)

    return reader


def reader_creator(corpus, word_dict, predicate_dict, label_dict):
    """The reference's 9-slot sample builder: words, the five
    predicate-context sequences (each broadcast to sentence length),
    predicate, the +-2-window mark flags, and label ids."""
    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)

            def ctx(offset, fallback):
                idx = verb_index + offset
                if 0 <= idx < len(labels):
                    if offset != 0:
                        mark[idx] = 1
                    return sentence[idx]
                return fallback

            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctxs = [[word_dict.get(c, UNK_IDX)] * sen_len
                    for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            pred_idx = [predicate_dict.get(predicate)] * sen_len
            label_idx = [label_dict.get(w) for w in labels]
            yield tuple([word_idx] + ctxs + [pred_idx, mark, label_idx])

    return reader


def _real_files():
    data = common.data_path("conll05st", ARCHIVE)
    dicts = [common.data_path("conll05st", f) for f in DICT_FILES]
    if os.path.exists(data) and all(os.path.exists(p) for p in dicts):
        return data, dicts
    return None, None


def get_dict():
    """(word_dict, verb_dict, label_dict) — real reference dict files
    when cached, synthetic id-named dicts otherwise."""
    _, dicts = _real_files()
    if dicts:
        return tuple(load_dict(p) for p in dicts)
    word_dict = {"w%d" % i: i for i in range(WORD_DICT_SIZE)}
    verb_dict = {"v%d" % i: i for i in range(PRED_DICT_SIZE)}
    label_dict = {"l%d" % i: i for i in range(LABEL_DICT_SIZE)}
    return word_dict, verb_dict, label_dict


def test_full():
    """The reference ``test()``: full 9-slot samples from the real
    corpus. Raises if the archive/dicts are not cached."""
    data, _ = _real_files()
    if data is None:
        raise IOError(
            "conll05st archive/dicts not cached under %s; the simplified "
            "synthetic readers are conll05.train()/test()"
            % common.data_path("conll05st", ""))
    word_dict, verb_dict, label_dict = get_dict()
    return reader_creator(corpus_reader(data), word_dict, verb_dict,
                          label_dict)


def _simplified_real():
    """(word id seq, label id seq) derived from the real 9-slot sample —
    the schema the tagging demo consumes."""
    full = test_full()

    def reader():
        for sample in full():
            yield (np.asarray(sample[0], np.int32),
                   np.asarray(sample[8], np.int32))

    return reader


def _synthetic(n, seed, min_len=5, max_len=40):
    def reader():
        local = np.random.RandomState(seed)
        for _ in range(n):
            length = local.randint(min_len, max_len + 1)
            words = local.randint(0, WORD_DICT_SIZE,
                                  size=length).astype(np.int32)
            # labels depend deterministically on words -> learnable
            labels = (words % LABEL_DICT_SIZE).astype(np.int32)
            yield words, labels

    return reader


def test(synthetic_size=512):
    if _real_files()[0]:
        return _simplified_real()
    return _synthetic(synthetic_size, seed=3)


def train(synthetic_size=4096):
    # like the reference, the public corpus is the test split — it backs
    # the training reader too (reference conll05.py test() docstring)
    if _real_files()[0]:
        return _simplified_real()
    return _synthetic(synthetic_size, seed=0)
