"""Reader creators and decorators (paddle_tpu/reader; parity:
python/paddle/v2/reader/decorator.py:26-220 — map_readers, buffered,
compose, chain, shuffle, firstn, cache; plus the xmap_readers thread pool
and, in ``decorator``, mix_readers)."""

from paddle_tpu_torch.reader.decorator import (
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    shuffle,
    xmap_readers,
)

__all__ = [
    "buffered", "cache", "chain", "compose", "firstn", "map_readers",
    "shuffle", "xmap_readers",
]
