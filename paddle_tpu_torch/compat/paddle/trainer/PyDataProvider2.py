"""@provider data-provider surface of the port
(compat/paddle/trainer/PyDataProvider2.py; reference: python/paddle/trainer/
PyDataProvider2.py:329 — the decorator that turned a user generator into a
C++-driven DataProvider with slot types, init hooks, caching and a
background pool).

Here the decorated function becomes a *reader factory* compatible with
``define_py_data_sources2`` (paddle_tpu_torch/config.py): calling it with a file
list returns a v2-style reader. The slot-type declarations flow to
data_layer() via the config registry; CACHE_PASS_IN_MEM keeps the decoded
samples in host RAM after the first pass (the reference's per-pass cache,
PyDataProvider2.cpp:66-71); background prefetch is the trainer's
``feed_pipeline`` (data/feeder.py) instead of a thread here.
"""

import os
import random

# slot type constructors are the public surface of this module
# (``from paddle.trainer.PyDataProvider2 import *``)
from paddle_tpu_torch.data_type import (  # noqa: F401
    dense_vector,
    dense_vector_sequence,
    dense_vector_sub_sequence,
    integer_value,
    integer_value_sequence,
    integer_value_sub_sequence,
    sparse_binary_vector,
    sparse_binary_vector_sequence,
    sparse_binary_vector_sub_sequence,
    sparse_vector,
    sparse_vector_sequence,
    sparse_vector_sub_sequence,
)

dense_slot = dense_vector
sparse_binary_slot = sparse_binary_vector
sparse_float_slot = sparse_vector
index_slot = integer_value


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class ProviderSettings:
    """The mutable bag handed to init hooks (reference: the `settings`
    object whose attributes — input_types, anything user-defined — the
    process generator reads)."""

    def __init__(self):
        self.input_types = None
        self.should_shuffle = None
        self.pool_size = -1
        self.logger = __import__(
            "paddle_tpu_torch.utils.logger", fromlist=["logger"]).logger


def _listify(value):
    """Normalize one slot value: py2-era providers yield map objects /
    generators; the feeder wants concrete sequences."""
    if isinstance(value, (map, filter, zip, range)):
        return list(value)
    return value


def _normalize(sample, input_types):
    if isinstance(sample, dict):
        if isinstance(input_types, dict):
            return tuple(_listify(sample[k]) for k in input_types)
        return tuple(_listify(v) for v in sample.values())
    if isinstance(sample, (tuple, list)):
        return tuple(_listify(v) for v in sample)
    return (_listify(sample),)


def _resolve_files(file_list):
    """A v1 file list: a path to a text file whose lines are data paths,
    or directly a python list of paths."""
    if isinstance(file_list, (list, tuple)):
        return [str(p) for p in file_list]
    with open(file_list) as f:
        return [ln.strip() for ln in f if ln.strip()]


class DataProviderDef:
    """What @provider returns: callable factory (file_list, **args) ->
    reader, plus eager settings construction for slot-type binding."""

    is_py_data_provider2 = True

    def __init__(self, fn, init_hook=None, cache=CacheType.NO_CACHE,
                 should_shuffle=None, input_types=None, **extra):
        self.fn = fn
        self.init_hook = init_hook
        self.cache = cache
        self.should_shuffle = should_shuffle
        self.input_types = input_types
        self.extra = extra
        self.__name__ = getattr(fn, "__name__", "provider")

    def make_settings(self, args=None):
        s = ProviderSettings()
        s.should_shuffle = self.should_shuffle
        s.input_types = self.input_types
        if self.init_hook is not None:
            self.init_hook(s, **(args or {}))
        return s

    def __call__(self, file_list, **args):
        settings = self.make_settings(args)
        files = _resolve_files(file_list)
        cached = [] if self.cache == CacheType.CACHE_PASS_IN_MEM else None
        state = {"done": False}

        def stream():
            for path in files:
                for sample in self.fn(settings, path):
                    yield _normalize(sample, settings.input_types)

        def shuffled(it):
            # buffered shuffle for the streaming path (the reference
            # shuffled its memory pool every pass); cached passes shuffle
            # the whole pass
            buf = []
            for sample in it:
                buf.append(sample)
                if len(buf) >= 4096:
                    random.shuffle(buf)
                    yield from buf
                    buf = []
            random.shuffle(buf)
            yield from buf

        def reader():
            if cached is not None and state["done"]:
                samples = list(cached)
                if settings.should_shuffle:
                    random.shuffle(samples)
                yield from samples
                return
            it = shuffled(stream()) if settings.should_shuffle else stream()
            if cached is None:
                yield from it
                return
            # fill a fresh list; commit to the cache only on a COMPLETE
            # pass (an abandoned pass must not leave partial duplicates)
            fresh = []
            for sample in it:
                fresh.append(sample)
                yield sample
            cached[:] = fresh
            state["done"] = True

        return reader


def provider(input_types=None, init_hook=None, cache=CacheType.NO_CACHE,
             should_shuffle=None, pool_size=-1, min_pool_size=-1,
             can_over_batch_size=True, calc_batch_size=None, check=False,
             check_fail_continue=False, **extra):
    """The @provider decorator (reference signature PyDataProvider2.py:329;
    always used with parentheses, as in the reference). Pool/batch knobs
    are accepted for compatibility; batching is the trainer's job here and
    prefetch is the trainer's feed_pipeline."""
    def deco(fn):
        return DataProviderDef(fn, init_hook=init_hook, cache=cache,
                               should_shuffle=should_shuffle,
                               input_types=input_types, **extra)

    return deco
