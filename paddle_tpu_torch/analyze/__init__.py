"""Framework-aware static analysis (paddle_tpu/analyze; docs/analyze.md),
read in PyTorch terms:

* :mod:`paddle_tpu_torch.analyze.lint` — AST checkers for the hazard
  classes: host syncs on step paths (PTA001), capture and export busters
  (PTA002), unmanaged threads (PTA003), unlocked module-level registries
  (PTA004), span hygiene (PTA009). ``cli analyze --all`` runs them over
  the port's tree and exits non-zero on findings.
* :mod:`paddle_tpu_torch.analyze.concurrency` — the interprocedural pass:
  per-class lock-guard inference (PTA005), the cross-module lock graph
  (PTA006), naked ``Condition.wait()`` (PTA007), and a captured CUDA
  graph's static tensors read after a later replay (PTA008).
* :mod:`paddle_tpu_torch.analyze.topology_check` — pre-dispatch checks
  on a built topology, no tracing: packing legality (the cross-position
  layer set DERIVED from the layer sources), index feed promotions,
  label quantization under mixed precision, the parameter partition, the
  programs a ``(topology, buckets, steps_per_call)`` combination makes
  (on the card, the CUDA graphs the fused loop captures) and the
  device-memory estimate. ``PADDLE_TPU_TORCH_ANALYZE=1`` makes
  ``trainer.SGD.train`` run it before the first dispatch.
* :mod:`paddle_tpu_torch.analyze.pytest_plugin` — dynamic gates: a
  per-test thread-leak gate and a :func:`max_retraces` budget.
"""

import contextlib

from paddle_tpu_torch.analyze.lint import (  # noqa: F401
    CHECKERS,
    Finding,
    format_finding,
    lint_paths,
    lint_source,
    lint_tree,
)
from paddle_tpu_torch.analyze.topology_check import (  # noqa: F401
    check_topology,
    estimate_hbm_bytes,
    format_report,
    hbm_budget_bytes,
    predict_jit_entries,
    scan_layer_modules,
    verify_reject_packed_coverage,
)


class RetraceBudgetExceeded(AssertionError):
    """A code region made more programs than its declared budget."""


@contextlib.contextmanager
def max_retraces(n):
    """Fail if the enclosed region makes more than ``n`` programs, counted
    by ``observe/steplog.watch_compiles``: every CUDA graph the trainer's
    fused loop captures and every ``torch.export`` program deserialized,
    on any thread; a cached graph or program is free. The dynamic half of
    :func:`predict_jit_entries`: the topology checker predicts the
    captures, this pins the live count.

    Counting is process-global: what OTHER threads capture or load during
    the region charges the budget too. Warm shared programs before the
    region when pinning exact counts."""
    from paddle_tpu_torch.observe import steplog

    with steplog.watch_compiles() as watcher:
        yield watcher
    if watcher.compiles > n:
        raise RetraceBudgetExceeded(
            "retrace budget exceeded: %d programs made, budget %d "
            "(events: %s)" % (watcher.compiles, n, watcher.events))
