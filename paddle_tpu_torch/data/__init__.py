"""The port's input pipeline (paddle_tpu/data): ``bucketing`` owns
length-bucketed batching and the bucket-choice rule the serving bundle
shares; ``feeder.DeviceFeeder`` converts batches into pinned host memory
and copies them to the card ahead of the train step.

The feeder loads lazily (PEP 562), as in the JAX package: the serving
bundle reaches ``bucketing`` through this package and does not pay for
the feeder's imports.
"""

from paddle_tpu_torch.data import bucketing
from paddle_tpu_torch.data.bucketing import (
    BucketBatch,
    bucket_for,
    bucket_index,
    derive_buckets,
    pack_feed,
    pack_samples,
    packed_batches,
    rebucket_batches,
)

_FEEDER_NAMES = ("DeviceFeeder", "FeedBatch", "feeder")


def __getattr__(name):
    if name in _FEEDER_NAMES:
        import importlib

        feeder = importlib.import_module("paddle_tpu_torch.data.feeder")

        globals()["feeder"] = feeder
        globals()["DeviceFeeder"] = feeder.DeviceFeeder
        globals()["FeedBatch"] = feeder.FeedBatch
        return globals()[name]
    raise AttributeError("module 'paddle_tpu_torch.data' has no attribute "
                         "%r" % name)


__all__ = [
    "BucketBatch", "DeviceFeeder", "FeedBatch", "bucket_for",
    "bucket_index", "bucketing", "derive_buckets", "pack_feed",
    "pack_samples", "packed_batches", "rebucket_batches",
]
