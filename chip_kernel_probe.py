#!/usr/bin/env python3
"""Probe the recurrent forward kernels of paddle_tpu_torch on the card.

    python3 chip_kernel_probe.py [layouts] [grid] [fwd [ROOT]] [e2e [ROOT]]
                                 [observe]

Readings that chip_smoke.py does not take, each printed as JSON lines
(the card's name and power limit first):

layouts  every layout of the LSTM and GRU forward that takes a shape
         (unit tiles, clusters, the grid), timed behind a sleep kernel at
         widths between the served ones: where the planners' switches
         lie (ops/lstm_kernels.fwd_plan, ops/gru_kernels.gru_fwd_plan).
grid     where the LSTM forward's grid layout spends its step at (T, B, H)
         = (100, 64, 1280): copies of csrc/lstm_seq_fwd.cu with one part
         taken out (the h staging; the h loads; every shared-memory load
         and the staging, leaving the FMAs), each built beside the source
         under paddle_tpu_torch/build/probe/ and timed, and one copy that
         prints the SM clock cycles of one step's K loop, cells and grid
         barrier (step 50, blocks 0 and 77, thread 0). The copies compute
         wrong values except the first and the clocked one.
fwd      lstm_seq_fwd and gru_seq_fwd of the package under ROOT (default:
         this checkout), in the layout its own planner picks, at the
         shapes chip_smoke.py reports for K1, K3 and K5 and the trained
         ones, float32 and bfloat16, timed as above: run once per checkout
         in separate processes (the package names collide) to set two
         versions side by side on one card.
e2e      the end-to-end phases of ROOT's own chip_smoke.py that the
         recurrent forward kernels serve (the flagship and the tagger,
         served and trained, and the flagship's eager and fused training
         loop), and nothing before them: two checkouts' host-bound times
         compared without the kernel phases each script runs first.
observe  chip_smoke.py's observe_card three times (the first cold), then
         each attribution call over the flagship's step bundle timed
         alone (profile_bundle, device_busy_ms, capture, profiler_trace
         and parse_trace_dir), and one profile of 40 steps read both ways:
         the profiler's raw results (what capture reads) and
         prof.events(), with their seconds and whether the kernels,
         calls, busy and window times agree.

Needs one CUDA card and nvcc; exits 2 without a card. ``layouts`` and
``grid`` are run when no reading is named.
"""

import concurrent.futures
import ctypes
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LSTM_SHAPES = [(100, 64, 320), (100, 64, 384), (100, 32, 384),
               (100, 32, 512), (100, 8, 512)]
GRU_SHAPES = [(30, 8, 512), (30, 32, 512)]
GRID_SHAPE = (100, 64, 1280)
FWD_SHAPES = {"lstm": [(64, 32, 256), (100, 64, 256), (100, 64, 1280)],
              "gru": [(128, 32, 256), (128, 64, 256)]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps=10):
    """Median CUDA-event time of ``fn``, each call queued behind a sleep
    kernel (chip_smoke.py's time_ms with queue_ahead)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def inputs(torch, steps, batch, hidden, dtype, gates):
    """Numpy-seeded inputs of the LSTM (``gates`` = 4) or GRU (3)
    forward, lengths including T, 0 and 1."""
    rng = np.random.RandomState(hidden + batch)
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device="cuda")

    mask = dev(np.arange(steps)[:, None] < lens[None, :], torch.float32)
    if gates == 4:
        return (dev(rng.randn(steps, batch, 4 * hidden) * 0.5), mask,
                dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
                dev(rng.randn(3, hidden) * 0.3, torch.float32),
                dev(rng.randn(batch, hidden) * 0.5),
                dev(rng.randn(batch, hidden) * 0.5))
    return (dev(rng.randn(steps, batch, 3 * hidden) * 0.5), mask,
            dev(rng.randn(hidden, 2 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(hidden, hidden) / np.sqrt(hidden)),
            dev(rng.randn(batch, hidden) * 0.5))


def probe_layouts(torch, lk, gk):
    dev = torch.device("cuda")
    sms, smem, clusters = lk.fwd_device_limits(dev)
    _, gsmem, gclusters = gk.fwd_device_limits(dev)
    for kind, shapes in (("lstm", LSTM_SHAPES), ("gru", GRU_SHAPES)):
        for steps, batch, hidden in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                unit = {"layout": "unit_tiles", "code": 0}
                if kind == "lstm":
                    args = inputs(torch, steps, batch, hidden, dtype, 4)
                    plans = {"unit_tiles": unit,
                             "cluster": lk.fwd_cluster_plan(
                                 batch, hidden, dtype, smem, clusters),
                             "grid": lk.grid_plan(batch, hidden, dtype, sms,
                                                  smem)}
                    planner = lk.fwd_plan(batch, hidden, dtype, sms, smem,
                                          clusters)["layout"]
                    fn = lk.lstm_seq_fwd
                else:
                    args = inputs(torch, steps, batch, hidden, dtype, 3)
                    plans = {"unit_tiles": unit,
                             "cluster": gk.fwd_cluster_plan(
                                 batch, hidden, dtype, gsmem, gclusters)}
                    planner = gk.gru_fwd_plan(batch, hidden, dtype, gsmem,
                                              gclusters)["layout"]
                    fn = gk.gru_seq_fwd
                row = {"probe": "layouts", "kernel": kind, "T": steps,
                       "B": batch, "H": hidden,
                       "dtype": str(dtype).replace("torch.", ""),
                       "planner": planner}
                for name, plan in plans.items():
                    if plan is not None:
                        row[name] = time_ms(
                            torch, lambda p=plan: fn(*args, plan=p))
                emit(row)


# text edits of csrc/lstm_seq_fwd.cu, each taking one part out of the
# grid kernel's float32 K loop (or clocking the step)
STAGE = ("        issue(0, 0);\n", "        if (nchunks > 1) issue(1, 1);\n",
         "          if (ch + 2 < nchunks) issue(ch + 2, (ch + 2) % "
         "kGrStages);\n")
HLOAD = (("const float4 ha = sm90::load4(hr + 4 * ((2 * rg) ^ sw));",
          "const float4 ha = make_float4(kk, kk + 1, kk + 2, kk + 3);"),
         ("const float4 hb = sm90::load4(hr + 4 * ((2 * rg + 1) ^ sw));",
          "const float4 hb = make_float4(kk, kk - 1, kk - 2, kk - 3);"))
WLOAD = (("const float4 wa = sm90::load4(wk + kk * wp);",
          "const float4 wa = make_float4(kk, ch, kk * 2, ch * 2);"),
         ("const float4 wb = sm90::load4(wk + kk * wp + 4);",
          "const float4 wb = make_float4(kk * 3, ch * 3, kk * 4, ch * 4);"))
CLOCK = (
    ("#include <cooperative_groups.h>",
     "#include <cstdio>\n#include <cooperative_groups.h>"),
    ("    const T* hsrc = hbuf + (t & 1) * hsz;\n",
     "    const T* hsrc = hbuf + (t & 1) * hsz;\n"
     "    long long q0 = clock64(), q1 = 0, q2 = 0;\n"),
    ("      // the cells of this pass\n",
     "      q1 = clock64();\n      // the cells of this pass\n"),
    ("    grid.sync();  // h_t complete everywhere before any block stages "
     "it\n",
     "    q2 = clock64();\n    grid.sync();  // h_t complete everywhere "
     "before any block stages it\n    if (t == 50 && (blockIdx.x == 0 || "
     "blockIdx.x == 77) && threadIdx.x == 0) printf(\"{\\\"probe\\\": "
     "\\\"grid_clock\\\", \\\"elem_bytes\\\": %d, \\\"block\\\": %d, "
     "\\\"k_loop_cycles\\\": %lld, \\\"cells_cycles\\\": %lld, "
     "\\\"barrier_cycles\\\": %lld}\\n\", (int)sizeof(T), blockIdx.x, "
     "q1 - q0, q2 - q1, clock64() - q2);\n"))


def edit(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise AssertionError("chip_kernel_probe: the source no longer "
                                 "holds %r" % old[:60])
        src = src.replace(old, new)
    return src


VARIANTS = {
    "whole": [],
    "no_h_staging": [(s, "") for s in STAGE],
    "no_h_staging_no_h_loads": [(s, "") for s in STAGE] + list(HLOAD),
    "fma_only": [(s, "") for s in STAGE] + list(HLOAD) + list(WLOAD),
    "clocked": list(CLOCK),
}


def build_variant(build, name):
    """Write and build one edited copy; returns the library path."""
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "lstm_seq_fwd.cu")).read()
    out_dir = os.path.join(ROOT, "paddle_tpu_torch", "build", "probe", name)
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                                         "*.cuh")):
        shutil.copy(header, out_dir)
    path = os.path.join(out_dir, "lstm_seq_fwd.cu")
    with open(path, "w") as fh:
        fh.write(edit(src, VARIANTS[name]))
    lib = os.path.join(out_dir, "liblstm_seq_fwd.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("building %s failed:\n%s" % (name, proc.stdout
                                                         + proc.stderr))
    return lib


def probe_grid(torch, build, lk):
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build_variant(build, n),
                                           VARIANTS)))
    steps, batch, hidden = GRID_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(torch, steps, batch, hidden, dtype, 4)
        plan = lk.grid_plan(batch, hidden, dtype)
        row = {"probe": "grid", "T": steps, "B": batch, "H": hidden,
               "dtype": str(dtype).replace("torch.", "")}
        for name, lib in libs.items():
            if dtype == torch.bfloat16 and name not in ("whole", "clocked",
                                                        "no_h_staging"):
                continue  # the edits of the other copies are float32's
            build._loaded["lstm_seq_fwd"] = ctypes.CDLL(lib)
            row[name + "_ms"] = time_ms(
                torch, lambda: lk.lstm_seq_fwd(*args, plan=plan))
            torch.cuda.synchronize()
        emit(row)
    build._loaded.pop("lstm_seq_fwd", None)


def probe_fwd(torch, lk, gk, root):
    for kind, fn, gates in (("lstm", lk.lstm_seq_fwd, 4),
                            ("gru", gk.gru_seq_fwd, 3)):
        for steps, batch, hidden in FWD_SHAPES[kind]:
            for dtype in (torch.float32, torch.bfloat16):
                args = inputs(torch, steps, batch, hidden, dtype, gates)
                fn(*args)
                torch.cuda.synchronize()
                emit({"probe": "fwd", "root": root, "kernel": kind,
                      "T": steps, "B": batch, "H": hidden,
                      "dtype": str(dtype).replace("torch.", ""),
                      "launch": dict(fn.last_launch),
                      "ms": time_ms(torch, lambda: fn(*args))})


def probe_e2e(torch, lk, gk, root):
    import tempfile

    import chip_smoke as smoke  # the checkout's own, from ``root``
    with tempfile.TemporaryDirectory() as tmp:
        smoke.phase_serve_flagship(torch, lk, tmp)
        smoke.phase_serve_tagger(torch, gk, tmp)
        smoke.phase_train_flagship(torch, lk, tmp)
        smoke.phase_train_loop(torch, lk, tmp)
    smoke.phase_train_tagger(torch, gk)


def probe_observe(torch, lk):
    import collections
    import tempfile
    import time

    import chip_smoke as smoke
    from paddle_tpu_torch.observe import attribution
    from paddle_tpu_torch.utils.stat import profiler_trace

    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(3):
            t0 = time.perf_counter()
            smoke.phase_observe_card(torch, lk, os.path.join(tmp,
                                                             str(attempt)))
            emit({"probe": "observe", "run": attempt,
                  "phase_s": time.perf_counter() - t0})
        rig = smoke.flagship_rig(256, smoke.SEED + 120)
        tr = rig.trainer("cuda")
        batch = smoke.train_batches(smoke.SEED + 121, 1, smoke.TRAIN_BATCH,
                                    False, smoke.FLAGSHIP["dict_size"])[0]
        bundle = smoke.StepBundle(torch, tr, tr._convert(batch, None)[0])

        def run(n):
            def steps():
                for _ in range(n):
                    bundle.carry = bundle.step(bundle.carry)
            return steps

        def traced():
            with profiler_trace(os.path.join(tmp, "trace")):
                run(5)()
                torch.cuda.synchronize()

        sync = torch.cuda.synchronize
        for label, fn in (
                ("profile_bundle_10",
                 lambda: attribution.profile_bundle(bundle, 10)),
                ("device_busy_ms_40",
                 lambda: attribution.device_busy_ms(bundle, 40)),
                ("capture_40", lambda: attribution.capture(run(40), sync)),
                ("profiler_trace_5", traced),
                ("parse_trace_dir",
                 lambda: attribution.parse_trace_dir(
                     os.path.join(tmp, "trace")))):
            t0 = time.perf_counter()
            fn()
            emit({"probe": "observe", "call": label,
                  "s": time.perf_counter() - t0})
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(40)()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = attribution.DeviceTrace(attribution._device_events(torch, prof))
    t1 = time.perf_counter()
    listed = attribution.DeviceTrace([
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA])
    t2 = time.perf_counter()
    emit({"probe": "observe", "reading": "raw_vs_events", "steps": 40,
          "raw_s": t1 - t0, "events_s": t2 - t1,
          "calls_equal": collections.Counter(raw.calls)
          == collections.Counter(listed.calls),
          "busy_us": [raw.busy_us, listed.busy_us],
          "window_us": [raw.window_us, listed.window_us],
          "per_op_max_diff_us": max(abs(raw.per_op_us[k]
                                        - listed.per_op_us[k])
                                    for k in listed.per_op_us)})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_probe: no CUDA device available", file=sys.stderr)
        return 2
    which = sys.argv[1:] or ["layouts", "grid"]
    root = ROOT
    for mode in ("fwd", "e2e"):
        if mode in which and which.index(mode) + 1 < len(which):
            root = os.path.abspath(which[which.index(mode) + 1])
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import gru_kernels as gk
    from paddle_tpu_torch.ops import lstm_kernels as lk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "observe" in which:
        _build.build_all(["lstm_seq_fwd", "lstm_seq_bwd"])
        probe_observe(torch, lk)
    if "e2e" in which:
        # the four recurrent libraries at once, not one by one at first use
        _build.build_all(["lstm_seq_fwd", "lstm_seq_bwd", "gru_seq_fwd",
                          "gru_seq_bwd"])
        probe_e2e(torch, lk, gk, root)
    if "fwd" in which:
        probe_fwd(torch, lk, gk, root)
    if "layouts" in which:
        probe_layouts(torch, lk, gk)
    if "grid" in which:
        probe_grid(torch, _build, lk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
