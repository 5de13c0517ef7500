"""paddle_tpu_torch.observe — spans, device attribution, step telemetry
and the bench regression gate (paddle_tpu/observe).

* :mod:`~paddle_tpu_torch.observe.spans` — nested named host spans,
  thread-safe, exportable as Chrome-trace/Perfetto JSON, feeding the
  :class:`paddle_tpu_torch.utils.stat.StatSet` aggregates.
* :mod:`~paddle_tpu_torch.observe.attribution` — the card's side:
  torch.profiler kernel events (captured, or read back from the Chrome
  traces the profiler writes), busy time as a union, the idle share of
  the wall and of the device window, top kernels and kernel classes, the
  gaps between them.
* :mod:`~paddle_tpu_torch.observe.regress` — the spread-aware bench
  regression gate (``cli observe --regress``) against named audited
  baselines.
* :mod:`~paddle_tpu_torch.observe.steplog` — the per-step JSONL sink with
  the JAX package's schema, activated by ``PADDLE_TPU_TORCH_TELEMETRY``.
* :mod:`~paddle_tpu_torch.observe.metrics` — counters, gauges and
  histograms under the JAX package's series names, as Prometheus text.
* :mod:`~paddle_tpu_torch.observe.sentinel` — the flight recorder and the
  loss sentinel (``PADDLE_TPU_TORCH_SENTINEL``: warn, halt or off).
* :mod:`~paddle_tpu_torch.observe.trainview` — per-worker health history,
  step-time skew and the elastic timeline of a telemetry directory.
* :mod:`~paddle_tpu_torch.observe.tracing` — request tracing for the
  serving tier: the W3C-traceparent-shaped ``TraceContext`` passed by
  value through every thread hop, ``PADDLE_TPU_TORCH_TRACE_SAMPLE``
  sampling, the slowest-N exemplar reservoir (``GET /debug/traces``) and
  the tail attribution ``cli observe`` prints.
* :mod:`~paddle_tpu_torch.observe.health` — the serving health history,
  the burn-rate SLO monitor (``GET /debug/slo``) and the trace/history
  merge over the serving fronts.

Each is stdlib-only but where it asks torch about the card (the
synchronize of a span with ``sync=``, the step log's ``backend`` and
``device_count``, ``attribution.capture``), which imports torch where it
runs.
"""

from paddle_tpu_torch.observe import (attribution, health,  # noqa: F401
                                      metrics, regress, sentinel, spans,
                                      steplog, tracing)
from paddle_tpu_torch.observe.tracing import TraceContext  # noqa: F401
from paddle_tpu_torch.observe.metrics import get_registry  # noqa: F401
from paddle_tpu_torch.observe.spans import get_tracer, span  # noqa: F401
from paddle_tpu_torch.observe.steplog import (StepLog, from_env,  # noqa: F401
                                              telemetry_dir)
