"""The port's data side against the JAX package, on the CPU: the reader
decorators (``paddle_tpu_torch/reader/decorator.py``) sample for sample,
``shuffle`` and ``mix_readers`` on a fixed seed, and their error and
thread-exit cases (tests/test_readers.py:44-184 mirrored); the first
samples of every synthetic dataset reader, field for field and dtype for
dtype; the real-archive parse paths on the staged fixtures of
tests/test_dataset_real.py (both packages' ``common.DATA_HOME``
monkeypatched to one directory); ``download`` over ``file://``;
``image.py`` on a seeded image; the ``SequenceBatch`` host converters and
helpers; and ``initializer.MSRA`` / ``default_weight_init``.

Every comparison is exact (host code on numpy: the same numbers, the same
dtypes), but the initializers', which draw from different generators and
are held by their statistics.
"""

import hashlib
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import image as jimage
from paddle_tpu import initializer as jinit
from paddle_tpu import reader as jreader
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.reader import decorator as jdec

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import image
from paddle_tpu_torch import initializer
from paddle_tpu_torch import reader
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.reader import decorator as dec

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _same(got, want, where="sample"):
    """``got`` equal to ``want`` exactly: the same container structure,
    numpy arrays of the same dtype and values, scalars of the same type."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "%s[%d]" % (where, i))
    elif isinstance(want, dict):
        assert got == want, where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _range(n):
    def r():
        yield from range(n)

    return r


def _reader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("reader-buffered", "reader-xmap"))]


def _assert_reader_threads_exit(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not any(t.is_alive() for t in _reader_threads()):
            return
        time.sleep(0.02)
    raise AssertionError("reader threads leaked: %s"
                         % [t.name for t in _reader_threads()])


# -- reader decorators ---------------------------------------------------------

DECORATED = {
    "map_readers": lambda m: m.map_readers(lambda a, b: a * 10 + b,
                                           _range(5), _range(5)),
    "shuffle": lambda m: m.shuffle(_range(23), 5, seed=1),
    "shuffle_unseeded_window": lambda m: m.shuffle(_range(4), 10, seed=3),
    "chain": lambda m: m.chain(_range(2), _range(3)),
    "compose": lambda m: m.compose(_range(3), lambda: iter([(7, 8)] * 3)),
    "compose_unchecked": lambda m: m.compose(_range(3), _range(1),
                                             check_alignment=False),
    "buffered": lambda m: m.buffered(_range(10), 4),
    "firstn": lambda m: m.firstn(_range(10), 3),
    "cache": lambda m: m.cache(_range(5)),
    "xmap_ordered": lambda m: m.xmap_readers(lambda x: x * 2, _range(20), 4,
                                             8, order=True),
    "mix_readers": lambda m: m.mix_readers(
        [lambda: iter(["a"] * 30), lambda: iter(["b"] * 10)],
        ratios=[3, 1], seed=7),
    "mix_readers_equal": lambda m: m.mix_readers(
        [lambda: iter([1, 2]), lambda: iter([10, 20, 30, 40])], seed=0),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_output_matches_jax(name):
    got, want = DECORATED[name](dec), DECORATED[name](jdec)
    assert list(got()) == list(want())
    assert list(got()) == list(want())  # a second pass (cache replays)


def test_xmap_unordered_gives_every_sample_once():
    out = list(dec.xmap_readers(lambda x: x * 2, _range(20), 4, 8)())
    assert sorted(out) == [2 * i for i in range(20)]


def test_reader_package_exports_what_jax_exports():
    assert reader.__all__ == jreader.__all__
    for name in reader.__all__:
        assert getattr(reader, name) is getattr(dec, name)
    # the feeder's handshake is the decorators' one copy
    from paddle_tpu_torch.data import feeder

    assert feeder._cancellable_put is dec._cancellable_put
    assert feeder._drain is dec._drain


def test_compose_off_by_one_raises():
    with pytest.raises(ValueError, match="different lengths"):
        list(dec.compose(_range(2), _range(1))())


def test_mix_readers_needs_one_ratio_per_reader():
    with pytest.raises(ValueError, match="one ratio per reader"):
        dec.mix_readers([_range(1), _range(2)], ratios=[1])


def test_cache_abandoned_first_pass_no_duplicates():
    cached = dec.cache(_range(5))
    it = cached()
    next(it), next(it)
    assert list(cached()) == list(range(5)) == list(cached())


def _bad_after_one():
    yield 1
    raise ValueError("boom")


def test_buffered_propagates_errors_and_threads_exit():
    with pytest.raises(ValueError, match="boom"):
        list(dec.buffered(_bad_after_one, 2)())
    _assert_reader_threads_exit()


def test_buffered_abandoned_consumer_no_thread_leak():
    it = dec.buffered(_range(10_000), 2)()
    assert next(it) == 0
    it.close()
    _assert_reader_threads_exit()


def test_xmap_abandoned_consumer_no_thread_leak():
    it = dec.xmap_readers(lambda x: x, _range(10_000), 3, 2)()
    next(it)
    it.close()
    _assert_reader_threads_exit()


def test_xmap_mapper_error_propagates_and_threads_exit():
    def bad(x):
        if x == 5:
            raise ValueError("mapper boom")
        return x

    with pytest.raises(ValueError, match="mapper boom"):
        list(dec.xmap_readers(bad, _range(10_000), 2, 2)())
    _assert_reader_threads_exit()


def test_xmap_source_reader_error_propagates_and_threads_exit():
    def bad_source():
        yield 1
        yield 2
        raise ValueError("source boom")

    with pytest.raises(ValueError, match="source boom"):
        list(dec.xmap_readers(lambda x: x, bad_source, 2, 4)())
    _assert_reader_threads_exit()


def test_batch_matches_jax():
    for drop_last in (True, False):
        assert (list(paddle.batch(_range(7), 3, drop_last=drop_last)())
                == list(jpaddle.batch(_range(7), 3, drop_last=drop_last)()))


# -- synthetic dataset readers ---------------------------------------------------

# (module, reader function, arguments): every reader the datasets offer
SYNTHETIC = [
    ("mnist", "train", {}), ("mnist", "test", {}),
    ("cifar", "train10", {}), ("cifar", "test10", {}),
    ("cifar", "train100", {}), ("cifar", "test100", {}),
    ("uci_housing", "train", {}), ("uci_housing", "test", {}),
    ("imdb", "train", {}), ("imdb", "test", {}),
    ("imdb", "train", {"word_idx": {"w%d" % i: i for i in range(500)}}),
    ("imikolov", "train", {"word_idx": {"w%d" % i: i for i in range(300)},
                           "n": 5}),
    ("imikolov", "test", {"word_idx": {"w%d" % i: i for i in range(300)},
                          "n": 3}),
    ("imikolov", "train", {"word_idx": {"w%d" % i: i for i in range(300)},
                           "n": -1, "mode": "seq"}),
    ("movielens", "train", {}), ("movielens", "test", {}),
    ("conll05", "train", {}), ("conll05", "test", {}),
    ("wmt14", "train", {}), ("wmt14", "test", {}),
    ("wmt14", "train", {"dict_size": 2000}),
    ("mq2007", "train", {}), ("mq2007", "test", {}),
    ("mq2007", "train_listwise", {}), ("mq2007", "test_listwise", {}),
    ("sentiment", "train", {}), ("sentiment", "test", {}),
    ("flowers", "train", {}), ("flowers", "test", {}),
    ("flowers", "valid", {"image_size": 8}),
    ("voc2012", "train", {}), ("voc2012", "test", {}),
    ("voc2012", "val", {"image_size": 8}),
]


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    """One empty dataset directory for both packages."""
    home = str(tmp_path / "dataset")
    monkeypatch.setattr(common, "DATA_HOME", home)
    monkeypatch.setattr(jcommon, "DATA_HOME", home)
    return home


def _modules(name):
    import importlib

    return (importlib.import_module("paddle_tpu_torch.dataset." + name),
            importlib.import_module("paddle_tpu.dataset." + name))


@pytest.mark.parametrize("module,fn,kwargs", SYNTHETIC,
                         ids=["%s.%s%s" % (m, f, "_" + "_".join(sorted(k))
                                           if k else "")
                              for m, f, k in SYNTHETIC])
def test_synthetic_reader_matches_jax(data_home, module, fn, kwargs):
    port, jax_mod = _modules(module)
    got = getattr(port, fn)(**kwargs)
    want = getattr(jax_mod, fn)(**kwargs)
    pairs = list(zip(range(12), got(), want()))
    assert len(pairs) == 12
    for i, g, w in pairs:
        _same(g, w, "%s.%s sample %d" % (module, fn, i))


def test_wmt14_synthetic_ids_ignore_dict_size_as_in_jax(data_home):
    """The JAX package's synthetic wmt14 draws ids up to 30000 whatever
    ``dict_size`` says; the port's gives the same samples."""
    port, _ = _modules("wmt14")
    top = max(int(max(s.max(), t.max())) for s, t, _ in
              (x for _, x in zip(range(64), port.train(dict_size=2000)())))
    assert top >= 2000


DICTS = [("imdb", "word_dict", {}), ("imdb", "word_dict", {"size": 40}),
         ("imikolov", "build_dict", {}), ("conll05", "get_dict", {}),
         ("movielens", "movie_categories", {}),
         ("movielens", "get_movie_title_dict", {}),
         ("movielens", "max_user_id", {}), ("movielens", "max_movie_id", {}),
         ("movielens", "max_job_id", {}), ("movielens", "age_table", {}),
         ("sentiment", "get_word_dict", {})]


@pytest.mark.parametrize("module,fn,kwargs", DICTS,
                         ids=["%s.%s%s" % (m, f, "_capped" if k else "")
                              for m, f, k in DICTS])
def test_synthetic_dicts_and_meta_match_jax(data_home, module, fn, kwargs):
    port, jax_mod = _modules(module)
    _same(getattr(port, fn)(**kwargs), getattr(jax_mod, fn)(**kwargs))


def test_module_constants_match_jax():
    for name in ("mnist", "cifar", "uci_housing", "imdb", "imikolov",
                 "movielens", "conll05", "wmt14", "mq2007", "sentiment",
                 "flowers", "voc2012"):
        port, jax_mod = _modules(name)
        consts = {k: v for k, v in vars(jax_mod).items()
                  if k.isupper() and isinstance(v, (int, float, str))}
        assert consts and all(getattr(port, k) == v
                              for k, v in consts.items()), name


def test_dataset_package_has_the_jax_modules():
    import paddle_tpu.dataset as jds

    import paddle_tpu_torch.dataset as ds

    mods = sorted(n for n, v in vars(jds).items()
                  if type(v).__name__ == "module")
    assert mods == sorted(n for n, v in vars(ds).items()
                          if type(v).__name__ == "module")
    assert len(mods) == 13


def test_synthetic_rng_matches_jax():
    for name, seed in (("mnist", 0), ("cifar10", 7), ("mq2007", 5)):
        np.testing.assert_array_equal(
            common.synthetic_rng(name, seed).randn(6),
            jcommon.synthetic_rng(name, seed).randn(6))


def test_data_home_reads_the_port_variable_then_the_jax_one(monkeypatch):
    import importlib

    monkeypatch.delenv("PADDLE_TPU_TORCH_DATA_HOME", raising=False)
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", "/data/shared")
    try:
        assert importlib.reload(common).DATA_HOME == "/data/shared"
        monkeypatch.setenv("PADDLE_TPU_TORCH_DATA_HOME", "/data/port")
        assert importlib.reload(common).DATA_HOME == "/data/port"
    finally:
        monkeypatch.undo()
        importlib.reload(common)


# -- the real-archive parse paths -------------------------------------------------

def _stage(home, module, *files):
    os.makedirs(os.path.join(home, module), exist_ok=True)
    for f in files:
        shutil.copy(os.path.join(FIXTURES, f), os.path.join(home, module, f))


CONLL_FILES = ("conll05st-tests.tar.gz", "wordDict.txt", "verbDict.txt",
               "targetDict.txt")

# (directory, fixture files, [(module, function, kwargs)]) read on both sides
REAL = {
    "imdb": ("imdb", ("aclImdb_v1.tar.gz",), [
        ("imdb", "build_dict", {"cutoff": 0}),
        ("imdb", "word_dict", {"size": 4, "cutoff": 0}),
        ("imdb", "word_dict", {}),
        ("imdb", "train!", {"cutoff": 0}), ("imdb", "test!", {"cutoff": 0}),
        ("imdb", "train!", {"size": 4, "cutoff": 0})]),
    "cifar": ("cifar", ("cifar-10-python.tar.gz",), [
        ("cifar", "train10", {}), ("cifar", "test10", {})]),
    "conll05": ("conll05st", CONLL_FILES, [
        ("conll05", "get_dict", {}), ("conll05", "test_full", {}),
        ("conll05", "train", {}), ("conll05", "test", {})]),
    "wmt14": ("wmt14", ("wmt14.tgz",), [
        ("wmt14", "train", {}), ("wmt14", "test", {}),
        ("wmt14", "train", {"dict_size": 4})]),
    "uci_housing": ("uci_housing", ("housing.data",), [
        ("uci_housing", "train", {}), ("uci_housing", "test", {})]),
    "movielens": ("movielens", ("ml-1m.zip",), [
        ("movielens", "movie_categories", {}),
        ("movielens", "get_movie_title_dict", {}),
        ("movielens", "max_user_id", {}), ("movielens", "max_movie_id", {}),
        ("movielens", "max_job_id", {}), ("movielens", "train", {}),
        ("movielens", "test", {})]),
    "imikolov": ("imikolov", ("simple-examples.tgz",), [
        ("imikolov", "build_dict", {"min_word_freq": 1}),
        ("imikolov", "train@", {"n": 3}), ("imikolov", "test@", {"n": 3}),
        ("imikolov", "train@", {"n": -1, "mode": "seq"})]),
}


def _call(mod, fn, kwargs):
    """A reader's whole output, a dict, or a value. ``name!`` takes the
    imdb word dict ``word_dict(**kwargs)`` as its ``word_idx``;
    ``name@`` the imikolov dict ``build_dict(min_word_freq=1)``."""
    if fn.endswith("!"):
        word_idx = mod.word_dict(**kwargs) if "size" in kwargs \
            else mod.build_dict(**kwargs)
        return list(getattr(mod, fn[:-1])(word_idx)())
    if fn.endswith("@"):
        return list(getattr(mod, fn[:-1])(mod.build_dict(min_word_freq=1),
                                          **kwargs)())
    out = getattr(mod, fn)(**kwargs)
    return list(out()) if callable(out) else out


@pytest.mark.parametrize("case", sorted(REAL))
def test_real_archive_parse_matches_jax(data_home, case):
    folder, files, calls = REAL[case]
    _stage(data_home, folder, *files)
    for module, fn, kwargs in calls:
        port, jax_mod = _modules(module)
        got, want = _call(port, fn, kwargs), _call(jax_mod, fn, kwargs)
        assert want, (module, fn)
        _same(got, want, "%s.%s(%s)" % (module, fn, kwargs))


def test_uci_housing_malformed_file_rejected(tmp_path):
    from paddle_tpu_torch.dataset import uci_housing

    bad = tmp_path / "housing.data"
    bad.write_text("1.0 2.0 3.0\n")
    with pytest.raises(ValueError, match="14 whitespace-separated"):
        uci_housing.load_data(str(bad))


def test_conll05_full_reader_needs_the_archive(data_home):
    from paddle_tpu_torch.dataset import conll05

    with pytest.raises(IOError, match="not cached"):
        conll05.test_full()


def test_download_over_file_url_fetches_verifies_and_caches(tmp_path,
                                                            monkeypatch):
    """common.download's contract on a file:// URL (no network): fetch,
    MD5 check, served from the cache once the source is gone, and an
    IOError after the retries for a payload whose checksum is wrong."""
    src = tmp_path / "payload.bin"
    src.write_bytes(b"real dataset bytes" * 100)
    md5 = hashlib.md5(src.read_bytes()).hexdigest()
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path / "cache"))
    url = "file://" + str(src)
    got = common.download(url, "unittest", md5sum=md5)
    assert got == common.data_path("unittest", "payload.bin")
    assert common.md5file(got) == md5
    src.unlink()
    assert common.download(url, "unittest", md5sum=md5) == got
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"garbage")
    with pytest.raises(IOError, match="cannot fetch"):
        common.download("file://" + str(bad), "unittest", md5sum="0" * 32)
    assert not os.path.exists(common.data_path("unittest", "bad.bin.part"))


# -- image.py ------------------------------------------------------------------------

@pytest.fixture
def img():
    return np.random.RandomState(4).randint(0, 256, (37, 52, 3)).astype(
        np.uint8)


IMAGE_CALLS = {
    "to_chw": lambda m, x: m.to_chw(x),
    "to_chw_order": lambda m, x: m.to_chw(x, order=(2, 1, 0)),
    "resize_short": lambda m, x: m.resize_short(x, 24),
    "resize_short_tall": lambda m, x: m.resize_short(x.transpose(1, 0, 2),
                                                     30),
    "center_crop": lambda m, x: m.center_crop(x, 20),
    "center_crop_larger": lambda m, x: m.center_crop(x, 60),
    "random_crop": lambda m, x: m.random_crop(x, 16,
                                              np.random.RandomState(1)),
    "left_right_flip": lambda m, x: m.left_right_flip(x),
    "simple_transform_train": lambda m, x: m.simple_transform(
        x, 32, 24, True, mean=[100.0, 110.0, 120.0],
        rng=np.random.RandomState(2)),
    "simple_transform_test": lambda m, x: m.simple_transform(
        x, 32, 24, False, rng=np.random.RandomState(2)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CALLS))
def test_image_matches_jax(img, name):
    _same(np.ascontiguousarray(IMAGE_CALLS[name](image, img)),
          np.ascontiguousarray(IMAGE_CALLS[name](jimage, img)), name)


# -- SequenceBatch: host converters and helpers -------------------------------------

SEQS = [np.arange(5, dtype=np.int32), np.arange(2, dtype=np.int32) + 7,
        np.zeros(0, np.int32), np.arange(9, dtype=np.int32) * 3]


def _pair(*args, **kwargs):
    return (SequenceBatch.from_sequences(SEQS, *args, **kwargs),
            JaxSeq.from_sequences(SEQS, *args, **kwargs))


@pytest.mark.parametrize("args,kwargs", [
    ((), {}), ((16,), {}), ((12, np.float32, -1), {}),
    ((), {"pad_value": 3}), ((10,), {"dtype": np.float32})])
def test_from_sequences_takes_the_jax_argument_order(args, kwargs):
    got, want = _pair(*args, **kwargs)
    _same(got.data.numpy(), np.asarray(want.data))
    _same(got.lengths.numpy(), np.asarray(want.lengths))
    if args:
        assert got.max_len == args[0]


def test_from_sequences_device_is_a_keyword():
    got = SequenceBatch.from_sequences(SEQS, 16, device="cpu")
    assert got.data.device.type == "cpu" and got.max_len == 16


def test_segment_ids_and_masked_data_match_jax():
    rng = np.random.RandomState(0)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (4, 0, 6, 1)]
    got = SequenceBatch.from_sequences(seqs, 8, pad_value=9.0)
    want = JaxSeq.from_sequences(seqs, 8, pad_value=9.0)
    _same(got.segment_ids().numpy(), np.asarray(want.segment_ids()))
    for pad in (0.0, -2.5):
        _same(got.masked_data(pad).numpy(), np.asarray(want.masked_data(pad)))


def test_flat_and_sequence_converters_match_jax():
    rng = np.random.RandomState(1)
    flat = rng.randn(12, 2).astype(np.float32)
    pos = [0, 3, 3, 10, 12]
    got = SequenceBatch.from_flat(flat, pos)
    want = JaxSeq.from_flat(flat, pos)
    _same(got.data.numpy(), np.asarray(want.data))
    _same(got.lengths.numpy(), np.asarray(want.lengths))
    for g, w in zip(got.to_flat(), want.to_flat()):
        _same(g, w)
    _same(got.to_sequences(), want.to_sequences())
    _same(SequenceBatch.from_flat(flat, pos, max_len=20).to_sequences(),
          JaxSeq.from_flat(flat, pos, max_len=20).to_sequences())


# -- initializer.MSRA and default_weight_init -----------------------------------------

def _draw(init, shape, seed=0):
    return init(torch.Generator().manual_seed(seed), shape, torch.float32,
                "cpu")


def _jax_draw(init, shape):
    import jax

    return np.asarray(init(jax.random.PRNGKey(0), shape, jnp.float32))


@pytest.mark.parametrize("make,shape", [
    (lambda m: m.MSRA(), (400, 300)), (lambda m: m.MSRA(fan_in=50), (400,
                                                                     300)),
    (lambda m: m.MSRA(), (3, 3, 64, 128)), (lambda m: m.MSRA(), (5000,)),
    (lambda m: m.default_weight_init(200), (400, 300)),
    (lambda m: m.default_weight_init(None), (256, 512))])
def test_msra_and_default_weight_init_match_jax_in_law(make, shape):
    """The same law as the JAX package's: zero mean and the same std (the
    fan_in rule included), checked on the sample statistics of both
    draws; one seed gives the same numbers twice."""
    got = _draw(make(initializer), shape).numpy()
    want = _jax_draw(make(jinit), shape)
    assert got.shape == want.shape == shape and got.dtype == np.float32
    n = got.size
    assert abs(got.mean()) <= 5 * want.std() / np.sqrt(n)
    assert abs(got.std() / want.std() - 1) <= 5 * np.sqrt(2.0 / n) + 1e-3
    assert torch.equal(_draw(make(initializer), shape),
                       _draw(make(initializer), shape))
    assert type(make(initializer)).__name__ == type(make(jinit)).__name__


def test_msra_std_is_sqrt_two_over_fan_in():
    got = _draw(initializer.MSRA(fan_in=8), (200, 500)).numpy()
    assert abs(got.std() - 0.5) < 0.01
    got = _draw(initializer.MSRA(), (3, 3, 2, 100)).numpy()  # fan_in 3
    assert abs(got.std() - np.sqrt(2 / 3)) < 0.03
