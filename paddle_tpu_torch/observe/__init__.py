"""paddle_tpu_torch.observe — spans, device attribution, step telemetry
(paddle_tpu/observe, less the serving tier's ``tracing`` and ``health``
and the bench gate ``regress``, which are not ported yet).

* :mod:`~paddle_tpu_torch.observe.spans` — nested named host spans,
  thread-safe, exportable as Chrome-trace/Perfetto JSON, feeding the
  :class:`paddle_tpu_torch.utils.stat.StatSet` aggregates.
* :mod:`~paddle_tpu_torch.observe.attribution` — the card's side:
  torch.profiler kernel events, busy time as a union, the idle share of
  the wall and of the device window, top kernels, the gaps between them.
* :mod:`~paddle_tpu_torch.observe.steplog` — the per-step JSONL sink with
  the JAX package's schema, activated by ``PADDLE_TPU_TORCH_TELEMETRY``.
* :mod:`~paddle_tpu_torch.observe.metrics` — counters, gauges and
  histograms under the JAX package's series names, as Prometheus text.
* :mod:`~paddle_tpu_torch.observe.sentinel` — the flight recorder and the
  loss sentinel (``PADDLE_TPU_TORCH_SENTINEL``: warn, halt or off).
* :mod:`~paddle_tpu_torch.observe.trainview` — per-worker health history,
  step-time skew and the elastic timeline of a telemetry directory.

Each is stdlib-only but where it asks torch about the card (the
synchronize of a span with ``sync=``, the step log's ``backend`` and
``device_count``, ``attribution.capture``), which imports torch where it
runs.
"""

from paddle_tpu_torch.observe import (attribution, metrics,  # noqa: F401
                                      sentinel, spans, steplog)
from paddle_tpu_torch.observe.metrics import get_registry  # noqa: F401
from paddle_tpu_torch.observe.spans import get_tracer, span  # noqa: F401
from paddle_tpu_torch.observe.steplog import (StepLog, from_env,  # noqa: F401
                                              telemetry_dir)
