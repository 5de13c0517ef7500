"""Aggregate timers (paddle_tpu/utils/stat.py; reference REGISTER_TIMER /
StatSet, paddle/utils/Stat.h:63,114,230-233).

Timers wrap host-visible phases (feed, the step's enqueue, the read-back)
and user scopes. A timer that times device work passes ``sync=`` a tensor
(or a nested dict/list of them): the scope then ends with a
``torch.cuda.synchronize`` on that tensor's card, so the wall time is the
work's and not its enqueue's. A CPU tensor needs no synchronize.
"""

import threading
import time
from contextlib import contextmanager


def sync_tensors(tree):
    """Wait for the card that holds the first CUDA tensor of ``tree`` (a
    tensor, or a nested dict/list/tuple of them); a no-op without one."""
    import torch

    stack = [tree]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.device.type == "cuda":
                torch.cuda.synchronize(item.device)
                return
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)


class StatInfo:
    __slots__ = ("name", "total", "count", "max", "min")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self.min = float("inf")

    def add(self, seconds):
        self.total += seconds
        self.count += 1
        self.max = max(self.max, seconds)
        self.min = min(self.min, seconds)

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0

    def __repr__(self):
        return "Stat(%s: total=%.4fs count=%d avg=%.4fs max=%.4fs min=%.4fs)" % (
            self.name, self.total, self.count, self.avg, self.max,
            0.0 if self.min == float("inf") else self.min,
        )


class StatSet:
    def __init__(self, name="global"):
        self.name = name
        self._lock = threading.Lock()
        self._stats = {}

    def get(self, name):
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = StatInfo(name)
            return stat

    @contextmanager
    def timer(self, name, sync=None):
        """Time a scope. ``sync`` is an optional tensor (tree) whose card
        is synchronized before the scope closes."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync_tensors(sync)
            self.get(name).add(time.perf_counter() - start)

    def print_all(self, log=None):
        if log is None:
            from paddle_tpu_torch.utils.logger import logger

            log = logger.info
        with self._lock:
            stats = sorted(self._stats.values(), key=lambda s: -s.total)
        log("======= StatSet: [%s] =======", self.name)
        for stat in stats:
            log("  %r", stat)

    def reset(self):
        with self._lock:
            self._stats.clear()

    def as_dict(self):
        with self._lock:
            return {
                k: {"total": v.total, "count": v.count, "avg": v.avg}
                for k, v in self._stats.items()
            }


global_stats = StatSet("global")
timer = global_stats.timer
