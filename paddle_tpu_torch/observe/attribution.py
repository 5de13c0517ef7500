"""Device attribution from torch.profiler traces (the device half of
paddle_tpu/observe/attribution.py, rebuilt for the card).

The JAX module parses XLA traces (the "XLA Modules"/"XLA Ops" tracks and
the HLO dump). Here the trace is torch.profiler's CUDA kernel events:

* :func:`capture` runs a function under ``torch.profiler`` and returns a
  :class:`DeviceTrace` of the kernels that ran on the card (None without
  a CUDA device, as the JAX capture returns None on the CPU);
* the busy time is the union of the kernels' intervals (kernels of two
  streams that overlap count once), and the idle share is measured two
  ways: of the host's wall time around the run, and of the device's own
  window, from the first kernel's start to the last one's end;
* :func:`op_report` gives the top kernels by device time and calls,
  :func:`dispatch_gap` the idle share and the largest gaps between
  kernels, flagging a host-bound region (many short kernels with the
  card idle between them) as the JAX one flags a dispatch-bound one;
* :func:`step_profile` is the per-step summary ``chip_smoke.py`` prints
  for each training phase.

The HLO reports (``load_hlo_defs``, ``fusion_groups``, ``conv_detail``)
have no counterpart: there is no HLO on this path.
"""

import collections
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
    (None when unknown)."""

    def __init__(self, kernels, wall_ms=None):
        self.kernels = sorted(kernels, key=lambda k: (k[1], k[2]))
        self.wall_ms = wall_ms
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
    kernels = [(evt.name, evt.time_range.start, evt.time_range.end)
               for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA]
    return DeviceTrace(kernels, wall_ms)


def op_report(trace, steps, top=None):
    """Top kernels by device time: dicts of name, ms_per_step,
    calls_per_step and pct of the kernels' summed time."""
    total = sum(trace.per_op_us.values()) or 1.0
    return [{"name": name, "ms_per_step": dur / steps / 1000.0,
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
