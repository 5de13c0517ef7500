"""Device attribution from torch.profiler traces (the device half of
paddle_tpu/observe/attribution.py, rebuilt for the card).

The JAX module parses XLA traces (the "XLA Modules"/"XLA Ops" tracks and
the HLO dump). Here the trace is torch.profiler's CUDA kernel events:

* :func:`capture` runs a function under ``torch.profiler`` and returns a
  :class:`DeviceTrace` of the kernels that ran on the card (None without
  a CUDA device, as the JAX capture returns None on the CPU);
  :func:`parse_trace_files` / :func:`parse_trace_dir` read the same
  events back from the Chrome traces the profiler writes
  (``utils.stat.profiler_trace``'s ``trace-<pid>-<n>.json``,
  ``export_chrome_trace``'s and the tensorboard handler's
  ``*.pt.trace.json[.gz]``): the ``"X"`` events of the categories
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
* :func:`device_busy_ms` and :func:`profile_bundle` trace the steps of a
  step bundle (any object with ``.step``, ``.carry`` and ``.fetch``);
* the busy time is the union of the kernels' intervals (kernels of two
  streams that overlap count once), and the idle share is measured two
  ways: of the host's wall time around the run, and of the device's own
  window, from the first kernel's start to the last one's end;
* :func:`op_report` gives the top kernels by device time and calls,
  :func:`classify` a kernel's class (:func:`class_report` the device
  time by class), :func:`dispatch_gap` the idle share and the largest
  gaps between kernels, flagging a host-bound region (many short kernels
  with the card idle between them) as the JAX one flags a dispatch-bound
  one, and :func:`report_text` all of it as printable text;
* :func:`step_profile` is the per-step summary ``chip_smoke.py`` prints
  for each training phase.

The HLO reports (``load_hlo_defs``, ``fusion_groups``, ``conv_detail``)
have no counterpart: there is no HLO on this path.
"""

import collections
import glob
import gzip
import json
import re
import time

# bf16 dense peak of one H100 SXM (NVIDIA's data sheet, 700 W)
H100_PEAK_TFLOPS = 989.0


def achieved(flops, ms):
    """(TFLOP/s, share of the H100's bf16 peak in %) for a step of
    ``flops`` taking ``ms``."""
    if not flops or not ms or ms != ms:
        return None, None
    tflops = flops / (ms / 1000.0) / 1e12
    return tflops, tflops / H100_PEAK_TFLOPS * 100.0


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


class DeviceTrace:
    """The kernels of one capture: ``kernels`` is a list of ``(name,
    start_us, end_us)``, ``wall_ms`` the host's wall time around the run
    (None when unknown), ``n_files`` the trace files merged into this
    view (:func:`parse_trace_files`)."""

    def __init__(self, kernels, wall_ms=None, n_files=1):
        self.kernels = sorted(kernels, key=lambda k: (k[1], k[2]))
        self.wall_ms = wall_ms
        self.n_files = n_files
        self.per_op_us = collections.Counter()
        self.calls = collections.Counter()
        for name, start, end in self.kernels:
            self.per_op_us[name] += end - start
            self.calls[name] += 1

    @property
    def busy_us(self):
        return union_us((s, e) for _, s, e in self.kernels)

    @property
    def window_us(self):
        if not self.kernels:
            return 0.0
        return max(e for _, _, e in self.kernels) - self.kernels[0][1]


def capture(run_fn, sync_fn):
    """Run ``run_fn()`` under torch.profiler (``sync_fn()`` before and
    after) and return the DeviceTrace of its CUDA kernels, or None when
    there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    sync_fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fn()
        sync_fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return DeviceTrace(_device_events(torch, prof), wall_ms)


def _device_events(torch, prof):
    """``(name, start_us, end_us)`` of the card's events in a finished
    profile, read from the profiler's raw results: ``prof.events()``
    holds the same events but first builds the host events' tree
    (seconds for a few dozen training steps). GPU user annotations are
    not the card's work and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    return [(evt.name(), (evt.start_ns() - t0) / 1e3,
             (evt.end_ns() - t0) / 1e3)
            for evt in results.events()
            if evt.device_type() == cuda
            and evt.name() not in ("[memory]", "[OutOfMemory]")
            and not getattr(evt, "is_user_annotation", lambda: False)()
            and not getattr(evt, "is_hidden_event", lambda: False)()]


# the Chrome-trace categories of the card's own work (the events capture
# reads from the profiler)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _load_trace_events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def parse_trace_files(files):
    """Merge the device events of every Chrome trace file into one
    DeviceTrace. Each file's timestamps are its own process's clock, so
    each resolves its events alone (as the JAX parser resolves its tracks
    per file) and is laid after the previous one: the busy time is the
    files' busy times summed, as the JAX trace sums its module time."""
    kernels = []
    offset = 0.0
    for path in files:
        events = [(ev["name"], float(ev["ts"]),
                   float(ev["ts"]) + float(ev["dur"]))
                  for ev in _load_trace_events(path)
                  if ev.get("ph") == "X" and "dur" in ev
                  and ev.get("cat") in _DEVICE_CATEGORIES]
        if not events:
            continue
        start = min(e[1] for e in events)
        kernels.extend((name, s - start + offset, e - start + offset)
                       for name, s, e in events)
        offset += max(e[2] for e in events) - start
    return DeviceTrace(kernels, n_files=len(files))


def parse_trace_dir(directory):
    """DeviceTrace of every trace file under ``directory`` (merged):
    ``trace-*.json`` and ``*.trace.json``, each also gzipped; None when
    the directory holds no trace."""
    files = sorted({path for pattern in ("trace-*.json", "*.trace.json",
                                         "trace-*.json.gz",
                                         "*.trace.json.gz")
                    for path in glob.glob(directory + "/**/" + pattern,
                                          recursive=True)})
    if not files:
        return None
    return parse_trace_files(files)


def device_busy_ms(bundle, steps=40):
    """The card's busy ms per step (the union of its kernels' intervals)
    over ``steps`` chained steps of a step bundle (``.step(carry) ->
    carry``, ``.carry``, ``.fetch(carry)``): the device's truth where
    the host's wall slope measures its own enqueue. The final carry is
    written back to ``bundle.carry``. None without a usable trace (no
    card: the CPU)."""
    state = {"c": bundle.carry}

    def run():
        for _ in range(steps):
            state["c"] = bundle.step(state["c"])

    try:
        trace = capture(run, lambda: bundle.fetch(state["c"]))
    except Exception:
        return None
    finally:
        bundle.carry = state["c"]
    if trace is None or not trace.kernels:
        return None
    return trace.busy_us / steps / 1000.0


def profile_bundle(bundle, steps=10):
    """Trace ``steps`` chained steps of a step bundle; returns the
    DeviceTrace (None without a card). One untimed step runs first (it
    builds the caches), and the final carry is written back."""
    state = {"carry": bundle.step(bundle.carry)}
    bundle.fetch(state["carry"])

    def run():
        for _ in range(steps):
            state["carry"] = bundle.step(state["carry"])

    trace = capture(run, lambda: bundle.fetch(state["carry"]))
    bundle.carry = state["carry"]
    return trace


# (pattern, class) in the order tried: the port's kernels (K1-K9 and the
# recurrent backward's recompute GEMM) by their own names, then cuDNN,
# cuBLAS / CUTLASS, NCCL and ATen's families. "recurrent" and
# "elementwise" have no JAX twin (there K1-K6 are "other", and XLA fuses
# elementwise work into "fusion").
_CLASSES = tuple((re.compile(pattern), tag) for pattern, tag in (
    (r"\b(lstm|gru)_(seq_)?(fwd|bwd)", "recurrent"),
    (r"memcpy|memset|copy", "copy"),
    (r"nccl", "collective"),
    (r"conv(?!ert)|\bbwdw_|fprop|dgrad|wgrad|implicit_gemm|cudnn|winograd",
     "conv"),
    (r"seqre::gemm|\bi8_(simt|splitk|tc|reduce)|int8_matmul|gemm|gemv|"
     r"nvjet|cublas|cutlass|splitkreduce|matmul", "dot"),
    (r"transpose", "transpose"),
    (r"pool.*(backward|bwd|grad)|(backward|bwd|grad).*pool", "pool_bwd"),
    (r"pool", "pool"),
    (r"scatter|index", "scatter"),
    (r"reduce|reduction", "reduce"),
    (r"elementwise", "elementwise")))


def classify(name):
    """Coarse class of a CUDA kernel name: the JAX package's tags where a
    counterpart exists (conv, dot, collective, copy, transpose, reduce,
    scatter, pool, pool_bwd, other) and ``recurrent`` (K1-K6) and
    ``elementwise`` (ATen's elementwise kernels)."""
    n = name.lower()
    for pattern, tag in _CLASSES:
        if pattern.search(n):
            return tag
    return "other"


def op_report(trace, steps, top=None):
    """Top kernels by device time: dicts of name, ms_per_step,
    calls_per_step and pct of the kernels' summed time."""
    total = sum(trace.per_op_us.values()) or 1.0
    return [{"name": name, "class": classify(name),
             "ms_per_step": dur / steps / 1000.0,
             "calls_per_step": trace.calls[name] / steps,
             "pct": 100.0 * dur / total}
            for name, dur in trace.per_op_us.most_common(top)]


def dispatch_gap(trace, steps=1, wall_ms_per_step=None,
                 gap_threshold_pct=25.0, min_execs_per_step=4, top_gaps=5):
    """The card's idle time between kernels. ``gap_pct`` is the idle share
    of the device window; with the trace's wall time (or
    ``wall_ms_per_step``) also the idle share of the wall. A region is
    host-bound when more than ``gap_threshold_pct`` of the window is idle
    across at least ``min_execs_per_step`` kernels a step: the host's
    enqueue, not the card, sets the step time. ``largest_gaps`` are the
    ``top_gaps`` longest idle stretches inside the window, as ``{"after",
    "before", "ms"}`` (the kernels on either side). None without
    kernels."""
    if not trace.kernels:
        return None
    window_us = max(trace.window_us, 1e-9)
    busy_us = trace.busy_us
    gap_us = max(window_us - busy_us, 0.0)
    gap_pct = 100.0 * gap_us / window_us
    execs_per_step = len(trace.kernels) / steps
    gaps, reach, last = [], None, None
    for name, start, end in trace.kernels:
        if reach is not None and start > reach:
            gaps.append({"after": last, "before": name,
                         "ms": (start - reach) / 1000.0})
        if reach is None or end > reach:
            reach, last = end, name
    gaps.sort(key=lambda g: -g["ms"])
    res = {
        "device_busy_ms_per_step": busy_us / steps / 1000.0,
        "window_ms_per_step": window_us / steps / 1000.0,
        "gap_ms_per_step": gap_us / steps / 1000.0,
        "gap_pct": gap_pct,
        "execs_per_step": execs_per_step,
        "mean_exec_us": sum(trace.per_op_us.values()) / len(trace.kernels),
        "largest_gaps": gaps[:top_gaps],
    }
    if wall_ms_per_step is None and trace.wall_ms:
        wall_ms_per_step = trace.wall_ms / steps
    if wall_ms_per_step:
        res["wall_ms_per_step"] = wall_ms_per_step
        res["wall_gap_ms_per_step"] = max(
            wall_ms_per_step - res["device_busy_ms_per_step"], 0.0)
        res["wall_idle_pct"] = 100.0 * res["wall_gap_ms_per_step"] \
            / wall_ms_per_step
    bound = (gap_pct >= gap_threshold_pct
             and execs_per_step >= min_execs_per_step)
    res["host_bound"] = bound
    if bound:
        res["diagnosis"] = (
            "host-bound: %.0f kernels/step averaging %.0fus with %.1f%% "
            "of the device window idle — the host's enqueue, not device "
            "compute, sets the step time" % (execs_per_step,
                                             res["mean_exec_us"], gap_pct))
    else:
        res["diagnosis"] = (
            "device-bound: %.1f%% of the device window idle over %.0f "
            "kernels/step — step time tracks device compute"
            % (gap_pct, execs_per_step))
    return res


def step_profile(trace, steps, kernels=(), top=8):
    """Where a run's time went, per step: wall ms (profiler on), the
    kernels' busy ms (the union of their intervals), the idle share of
    the wall and of the device window, kernels per step, the ``top``
    kernels by device time, and for each name fragment in ``kernels`` the
    device ms per step of the kernels whose names contain it and their
    share of the busy time."""
    busy_us = trace.busy_us
    window_us = trace.window_us
    mine = {}
    for frag in kernels:
        us = sum(t for name, t in trace.per_op_us.items() if frag in name)
        mine[frag] = {"ms_per_step": us / 1e3 / steps,
                      "share_of_busy": us / busy_us if busy_us else 0.0}
    return {"steps": steps, "device_events": len(trace.kernels),
            "kernels": mine,
            "wall_ms_per_step": trace.wall_ms / steps,
            "busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / 1e3 / trace.wall_ms,
            "device_window_idle_share": (1.0 - busy_us / window_us
                                         if window_us else None),
            "kernels_per_step": len(trace.kernels) / steps,
            "top": [{"kernel": row["name"][:100],
                     "ms_per_step": row["ms_per_step"],
                     "calls_per_step": row["calls_per_step"]}
                    for row in op_report(trace, steps, top=top)]}


def class_report(trace, steps):
    """Device time grouped by kernel class: list of (class, ms_per_step,
    pct of the kernels' summed time)."""
    total = sum(trace.per_op_us.values()) or 1.0
    by_class = collections.Counter()
    for name, dur in trace.per_op_us.items():
        by_class[classify(name)] += dur
    return [(tag, dur / steps / 1000.0, 100.0 * dur / total)
            for tag, dur in by_class.most_common()]


def report_text(trace, steps, hlo_defs=None, top=40, flops_per_step=None,
                wall_ms_per_step=None):
    """The per-kernel attribution report as printable text, the JAX
    package's layout: the card's busy time (the union of its kernels'
    intervals) takes the place of the XLA module time, the dispatch gap
    diagnoses a host-bound region, and ``achieved`` is of the H100's
    peak. ``hlo_defs`` must be None (there is no HLO on this path)."""
    if hlo_defs is not None:
        _no_hlo("report_text(hlo_defs=)")()
    lines = []
    busy_ms = trace.busy_us / steps / 1000.0
    lines.append(
        "busy total: %.3f ms/step | op total: %.3f ms/step  "
        "(%d steps, %d trace file%s)"
        % (busy_ms, sum(trace.per_op_us.values()) / steps / 1000.0,
           steps, trace.n_files, "" if trace.n_files == 1 else "s"))
    if flops_per_step and busy_ms:
        tflops, peak_pct = achieved(flops_per_step, busy_ms)
        lines.append("achieved: %.1f TFLOP/s = %.1f%% of the H100's bf16 "
                     "peak (static step FLOPs / device-busy time)"
                     % (tflops, peak_pct))
    gap = dispatch_gap(trace, steps, wall_ms_per_step=wall_ms_per_step)
    if gap is not None:
        lines.append("dispatch gap: busy %.3f / window %.3f ms/step "
                     "(%.1f%% idle, %.0f kernels/step) -> %s"
                     % (gap["device_busy_ms_per_step"],
                        gap["window_ms_per_step"], gap["gap_pct"],
                        gap["execs_per_step"], gap["diagnosis"]))
    lines.append("")
    lines.append("by class (ms/step):")
    for tag, ms, pct in class_report(trace, steps):
        lines.append("  %-12s %8.3f  (%4.1f%%)" % (tag, ms, pct))
    lines.append("")
    lines.append("top kernels (ms/step, calls/step):")
    for row in op_report(trace, steps, top=top):
        lines.append("  %8.3f  x%-4d %s"
                     % (row["ms_per_step"], int(row["calls_per_step"]),
                        row["name"][:110]))
    return "\n".join(lines)


def _no_hlo(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            "attribution.%s is not ported yet: it reads an XLA HLO dump, "
            "and the port's path has no HLO" % name)

    refuse.__name__ = name
    return refuse


load_hlo_defs = _no_hlo("load_hlo_defs")
fusion_groups = _no_hlo("fusion_groups")
conv_detail = _no_hlo("conv_detail")
