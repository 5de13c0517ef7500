#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) once on the card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero and prints no
result line:

1. env     card name and power limit (nvidia-smi), torch/CUDA versions;
           TF32 off for matmuls and cuDNN.
2. build   compile the port's kernel libraries from csrc/, one nvcc each,
           in parallel.
3. kernel  lstm_seq_fwd (csrc/lstm_seq_fwd.cu) against its plain PyTorch
           version on the card: T=64, B in {1, 8, 32}, H=256 (the served
           flagship) and T=100, B=64, H=1280 (the wide row), in float32 and
           bfloat16; errors, CUDA-event times, the bound, and cuDNN's LSTM
           time for information (not the same function); then T=32, B=128,
           H=1280, which runs as several launches of row chunks.
4. kernel_bwd  lstm_seq_bwd (csrc/lstm_seq_bwd.cu) the same way at
           (T, B, H) = (100, 64, 256) (the training bench row), (64, 8,
           256), (100, 64, 1280) (the wide row) and (32, 128, 1280) (row
           chunks), float32 and bfloat16; cuDNN's LSTM forward + backward
           for information.
5. serve   the flagship text classifier at full width (vocab 30000, emb
           128, 2 x LSTM 256, 2 classes, random weights from a numpy seed)
           exported as a bundle, served by the batching engine and over
           HTTP, every answer held against the same bundle run on the CPU,
           and the kernel's launch count against the dispatched batches.
6. serve   the same model at hidden 1280 (bucket 64, seq_len 100).
7. train_flagship  the same model plus a label and classification_cost,
           trained by trainer.SGD with Momentum(0.01, 0.9) on the card:
           3 ragged steps held against the same steps on the CPU (costs and
           every parameter), every gradient of step 1 finite and nonzero,
           20 steps at batch 64, length 100 (ms per batch, launch counts),
           the same under the bfloat16 compute policy, and the trained
           parameters exported as a bundle whose answers match
           inference.infer on the CPU.
8. train_h1280  hidden 1280, batch 64, length 100: a few steps on the card
           (ms per batch, launch counts) and one step on 8 rows held
           against the CPU (cost and every gradient).
9. kernel_gru  gru_seq_fwd (csrc/gru_seq_fwd.cu) against its plain
           version at (T, B, H) = (128, 1|8|32, 256) (the served tagger),
           (128, 64, 256) (the trained tagger) and (30, 64, 512) (the NMT
           encoder's width), float32 and bfloat16, ragged masks; errors,
           CUDA-event times, the bound, and cuDNN's GRU time for scale
           (not the same function).
10. kernel_gru_bwd  gru_seq_bwd (csrc/gru_seq_bwd.cu) the same way at
           (128, 64, 256) and (30, 64, 512).
11. serve_tagger  the GRU sequence tagger (vocab 1000, emb 32, GRU 256,
           32 labels, random weights from a numpy seed) exported with
           buckets 1/8/32 and seq_len 128, a burst of 16 requests of 1-8
           rows with lognormal lengths, then 3 HTTP requests; every
           per-timestep probability held against the same bundle on the
           CPU, and the forward kernel's launches against the dispatched
           batches.
12. train_tagger  the tagger plus a sequence label and
           classification_cost, trained by trainer.SGD with
           Momentum(1e-3, 0.9) at batch 64: 3 ragged steps held against
           the CPU (costs and every parameter), bfloat16 against float32,
           20 steps at length 128 in each (ms per batch, 1 forward and 1
           backward GRU launch per step) and a torch.profiler summary.
13. kernel_conv  conv2d_same_fwd (csrc/conv2d_same_fwd.cu, K7) against its
           plain version at the 13 distinct stride-1 conv shapes of
           ResNet-50 at batch 64 (and at N=1, and C=F=8 at an odd width),
           float32 and bfloat16: errors, CUDA-event times, the bound, and
           the time of F.conv2d (cuDNN, TF32 off), which computes the same
           function.
14. kernel_conv_bwd  the data gradient (K7 on the flipped, transposed
           weight) and conv2d_same_bwd_filter (csrc/conv2d_same_bwdw.cu, K8)
           the same way, with aten.convolution_backward as the library
           time of each.
15. serve_resnet  ResNet-50 at full size (224x224, 1000 classes, random
           weights and batch-norm statistics from a numpy seed) exported
           with buckets 1/8/32, a burst of 8 requests of 1-4 images through
           the engine and 2 HTTP requests of 1 image, every probability
           held against the same bundle on the CPU, and K7's launches
           against 46 per dispatched batch.
16. train_resnet  ResNet-50 plus a label and classification_cost, trained
           by trainer.SGD with Momentum(0.01, 0.9): 3 steps on 4 images
           against the same steps on the CPU (step 1's cost and moving
           statistics, its whole update, the 3 costs; every parameter and
           statistic after 3 steps reported), every gradient of step 1
           finite and nonzero, 10 steps at batch 64 in f32 and bf16 (ms per
           batch, images per second, exactly 92 K7 and 46 K8 launches per
           step), a torch.profiler summary, and the trained parameters and
           statistics exported as a bundle whose answers match
           inference.infer on the CPU.
17. kernels one entry per TPU kernel the port replaced, then the card's
           name and power limit, then the last line
           {"ok": true, "device": {...}}.

Needs one CUDA card; exits 2 without one.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 1234
# float32: the kernel and its plain version sum h.W_rec in a different
# order (and the card's expf/tanhf differ from PyTorch's in the last ulp),
# so they agree to rounding, not bit for bit.
TOL_F32 = 1e-4
# bfloat16: h is rounded to bfloat16 every step in both versions; a
# different summation order can flip one rounding, and the flip feeds
# through the recurrence.
TOL_BF16 = 3e-2
TOL_SERVE = 1e-4          # probabilities, card vs CPU (both float32)
# backward kernel vs its plain version, max |err| over dgates, dh0, dc0 and
# dpeep, each divided by max(1, its largest |value|): float32 sums both
# GEMVs in another order; in bfloat16 a flipped rounding of dz feeds
# through the dh carry
TOL_BWD = {"float32": 1e-4, "bfloat16": 3e-2}
# training, card vs CPU (float32): every GEMM, both LSTM kernels and the
# embedding gradient's scatter-add sum in another order than the CPU's;
# on the mean cost and on every parameter after 3 steps (absolute), and on
# each gradient divided by its largest |entry|
TOL_TRAIN = 1e-4
# training, bfloat16 policy vs float32, both on the card: the mean cost of
# each of the 3 ragged steps (bfloat16 keeps about 3 significant digits,
# and the rounding compounds through 2 LSTM layers of 100 steps)
TOL_TRAIN_BF16 = 5e-2
# ResNet-50 training, card vs CPU on 4 images (float32). Step 1's cost and
# every moving statistic after it (each relative to its tensor's largest
# |entry|) are forward values: TOL_TRAIN. Its gradient is not: in train
# mode at this batch ResNet-50's gradient is ill-conditioned, in the JAX
# package as in the port (tests/test_torch_resnet.py): on the CPU at
# 32x32, float32 against float64 moves the whole gradient by 2.0e-2
# (norm-wise) and some channels by 30 %, so a zero-initialised tensor (a
# beta) differs after one step by that much relative to its own largest
# entry, and the next steps amplify it (measured on one H100, 3 steps:
# 1.23 for a beta, 0.33 for a moving mean near 0). Held instead: step 1's
# whole update, ||card - CPU|| / ||CPU update|| over all parameters
# (measured on one H100: 2.7e-2), and the 3 steps' costs relative to
# max(1, |cost|) (measured on one H100 in two runs: 5.9e-3 and 5.1e-3).
TOL_TRAIN_RESNET_UPDATE = 1e-1
TOL_TRAIN_RESNET_COST = 2e-2
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, data sheet

KERNEL_CASES = [(64, 1, 256), (64, 8, 256), (64, 32, 256), (100, 64, 1280)]
# a batch whose grid is not co-resident in one launch: the wrapper splits
# it into row chunks (checked, not on the main path)
CHUNKED_CASES = [(32, 128, 1280)]
BWD_CASES = [(100, 64, 256), (64, 8, 256), (100, 64, 1280)]
BWD_CHUNKED_CASES = [(32, 128, 1280)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, H1280_STEPS = 64, 100, 20, 5
FLAGSHIP = {"dict_size": 30000, "emb_size": 128, "hidden": 256,
            "num_classes": 2, "num_layers": 2}
BUILDER = "paddle_tpu_torch.models.text:text_classification_lstm"
# the GRU kernels at the tagger's served and trained shapes and at the NMT
# encoder's width (benchmark/harness.py:476)
GRU_CASES = [(128, 1, 256), (128, 8, 256), (128, 32, 256), (128, 64, 256),
             (30, 64, 512)]
GRU_BWD_CASES = [(128, 64, 256), (30, 64, 512)]
# the tagger of benchmark/exp_serve.py:154-168 (served at seq_len 128) and
# of benchmark/exp_checkpoint.py:78-94 (trained with Momentum(1e-3, 0.9))
TAGGER = {"dict_size": 1000, "label_size": 32, "emb_size": 32, "hidden": 256}
TAGGER_BUILDER = "paddle_tpu_torch.models.text:sequence_tagging_gru"
TAGGER_SEQ = 128
# the tagger's cost is a sum over up to 128 per-timestep costs (about 440
# at the start): its limits, card vs CPU (TOL_TRAIN) and bfloat16 vs
# float32 (TOL_TRAIN_BF16), apply to the cost divided by max(1, |cost|)
DEVICE = "cuda"
# ResNet-50 as benchmark/harness.py builds it for the vision bench row
RESNET = {"depth": 50, "num_classes": 1000, "im_size": 224}
RESNET_BUILDER = "paddle_tpu_torch.models.vision:resnet"
RESNET_PIXELS = 3 * 224 * 224
RESNET_BATCH, RESNET_STEPS = 64, 10
# ResNet-50's stride-1 convs (k, C, F, H=W) with their number in one
# forward: 46 in all, every one in the kernels' family
RESNET_CONVS = [(1, 64, 64, 57, 1), (3, 64, 64, 57, 3), (1, 64, 256, 57, 4),
                (1, 256, 64, 57, 2), (3, 128, 128, 29, 4),
                (1, 128, 512, 29, 4), (1, 512, 128, 29, 3),
                (3, 256, 256, 15, 6), (1, 256, 1024, 15, 6),
                (1, 1024, 256, 15, 5), (3, 512, 512, 8, 3),
                (1, 512, 2048, 8, 3), (1, 2048, 512, 8, 2)]
# (N, H, W, C, F, k): the 13 shapes at batch 64, then N=1 and the narrowest
# channels at an odd width
CONV_CASES = ([(RESNET_BATCH, hw, hw, c, f, k)
               for k, c, f, hw, _ in RESNET_CONVS]
              + [(1, 57, 57, 64, 64, 3), (64, 17, 23, 8, 8, 3)])
# K7 and the data gradient against their plain versions, divided by
# max(1, max |plain|): float32 sums in another order; bfloat16 rounds the
# float32 sum once, and the two roundings can land one bfloat16 step
# (2^-8 relative) apart. K8 returns float32 in both cases.
TOL_CONV = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_CONV_BWDW = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, warmup=3, reps=20):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def lstm_bound_ms(steps, batch, hidden, dtype_name):
    """Least time for the function: bytes it must move (each input read
    once, each output written once) over HBM rate, or its recurrent GEMM
    FLOPs (2*T*B*H*4H) over the peak rate for the dtype, whichever is
    larger."""
    isz = 2 if dtype_name == "bfloat16" else 4
    g4 = 4 * hidden
    nbytes = (steps * batch * g4 * isz + steps * batch * 4 + hidden * g4 * isz
              + 3 * hidden * 4 + 2 * batch * hidden * isz
              + 2 * steps * batch * hidden * isz)
    flops = 2.0 * steps * batch * hidden * g4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(torch, steps, batch, hidden, dtype, seed):
    """Numpy-seeded inputs: nonzero peepholes and h0/c0, lengths that
    include 0, 1 and T (as far as the batch allows)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, steps + 1, batch)
    for i, n in enumerate((steps, 0, 1)[:batch]):
        lens[i] = n
    mask = (np.arange(steps)[:, None] < lens[None, :]).astype(np.float32)

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=DEVICE)

    return (dev(rng.randn(steps, batch, 4 * hidden) * 0.5),
            dev(mask, torch.float32),
            dev(rng.randn(hidden, 4 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(3, hidden) * 0.3, torch.float32),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))


def phase_kernel(torch, lk):
    results = []
    for steps, batch, hidden in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = kernel_inputs(torch, steps, batch, hidden, dtype,
                                 SEED + batch + hidden)
            h_k, c_k = lk.lstm_seq_fwd(*args)
            torch.cuda.synchronize()
            launch = dict(lk.lstm_seq_fwd.last_launch)
            h_r, c_r = lk.lstm_seq_fwd_reference(*args)
            err = max((h_k.float() - h_r.float()).abs().max().item(),
                      (c_k.float() - c_r.float()).abs().max().item())
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
            ms = time_ms(torch, lambda: lk.lstm_seq_fwd(*args))
            plain_ms = time_ms(torch,
                               lambda: lk.lstm_seq_fwd_reference(*args),
                               warmup=1)
            cudnn = torch.nn.LSTM(hidden, hidden).to(DEVICE, dtype)
            cudnn.flatten_parameters()
            x = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype)
            with torch.no_grad():
                cudnn_ms = time_ms(torch, lambda: cudnn(x))
            bound, bound_by = lstm_bound_ms(steps, batch, hidden, name)
            row = {"phase": "kernel", "kernel": "lstm_seq_fwd", "T": steps,
                   "B": batch, "H": hidden, "dtype": name,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by,
                   "cudnn_lstm_ms_not_same_function": cudnn_ms,
                   "launch": launch}
            emit(row)
            if not err <= tol:
                raise AssertionError("lstm_seq_fwd disagrees with its plain "
                                     "version: %r" % row)
            results.append(row)
    for steps, batch, hidden in CHUNKED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = kernel_inputs(torch, steps, batch, hidden, dtype,
                                 SEED + batch + hidden)
            h_k, c_k = lk.lstm_seq_fwd(*args)
            torch.cuda.synchronize()
            launch = dict(lk.lstm_seq_fwd.last_launch)
            h_r, c_r = lk.lstm_seq_fwd_reference(*args)
            err = max((h_k.float() - h_r.float()).abs().max().item(),
                      (c_k.float() - c_r.float()).abs().max().item())
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
            row = {"phase": "kernel_chunked", "kernel": "lstm_seq_fwd",
                   "T": steps, "B": batch, "H": hidden, "dtype": name,
                   "max_abs_err": err, "tol": tol,
                   "ms": time_ms(torch, lambda: lk.lstm_seq_fwd(*args)),
                   "launch": launch}
            emit(row)
            if not (err <= tol and launch["launches"] >= 2):
                raise AssertionError("chunked lstm_seq_fwd: %r" % row)
    return results


def lstm_bwd_bound_ms(steps, batch, hidden, dtype_name):
    """Least time for the backward: its bytes (gates, mask, W, peep, hprev,
    cprev, c_seq, dh_seq, dh_f, dc_f read once; dgates, dh0, dc0, dpeep
    written once) over HBM rate, or its two recurrent GEMMs (recompute
    h.W and dz.W^T, 2 * 2*T*B*H*4H FLOPs) over the peak rate for the
    dtype, whichever is larger."""
    isz = 2 if dtype_name == "bfloat16" else 4
    g4 = 4 * hidden
    nbytes = (2 * steps * batch * g4 * isz + steps * batch * 4
              + hidden * g4 * isz + 2 * 3 * hidden * 4
              + 4 * steps * batch * hidden * isz + 4 * batch * hidden * isz)
    flops = 2 * 2.0 * steps * batch * hidden * g4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_inputs(torch, lk, steps, batch, hidden, dtype, seed):
    """The backward's inputs from a forward of numpy-seeded inputs (plain
    version on the card), with numpy-seeded cotangents."""
    gates, mask, w, peep, h0, c0 = kernel_inputs(torch, steps, batch, hidden,
                                                 dtype, seed)
    h_seq, c_seq = lk.lstm_seq_fwd_reference(gates, mask, w, peep, h0, c0)
    rng = np.random.RandomState(seed + 1)

    def dev(a):
        return torch.tensor(a, dtype=dtype, device=DEVICE)

    return (gates, mask, w, peep, torch.cat([h0[None], h_seq[:-1]]),
            torch.cat([c0[None], c_seq[:-1]]), c_seq,
            dev(rng.randn(steps, batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5),
            dev(rng.randn(batch, hidden) * 0.5))


def bwd_error(got, want):
    """max over the outputs of max |got - want| / max(1, max |want|)."""
    return max(float((g.float() - w.float()).abs().max())
               / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


def phase_kernel_bwd(torch, lk):
    results = []
    for steps, batch, hidden in BWD_CASES + BWD_CHUNKED_CASES:
        chunked = (steps, batch, hidden) in BWD_CHUNKED_CASES
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = bwd_inputs(torch, lk, steps, batch, hidden, dtype,
                              SEED + 7 * batch + hidden)
            got = lk.lstm_seq_bwd(*args)
            torch.cuda.synchronize()
            launch = dict(lk.lstm_seq_bwd.last_launch)
            err = bwd_error(got, lk.lstm_seq_bwd_reference(*args))
            tol = TOL_BWD[name]
            ms = time_ms(torch, lambda: lk.lstm_seq_bwd(*args))
            plain_ms = time_ms(torch,
                               lambda: lk.lstm_seq_bwd_reference(*args),
                               warmup=1, reps=5)
            cudnn = torch.nn.LSTM(hidden, hidden).to(DEVICE, dtype)
            cudnn.flatten_parameters()
            x = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype,
                            requires_grad=True)
            dy = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype)

            def cudnn_fwd_bwd():
                cudnn(x)[0].backward(dy)

            bound, bound_by = lstm_bwd_bound_ms(steps, batch, hidden, name)
            row = {"phase": "kernel_bwd", "kernel": "lstm_seq_bwd",
                   "T": steps, "B": batch, "H": hidden, "dtype": name,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by,
                   "cudnn_lstm_fwd_bwd_ms_not_same_function":
                       time_ms(torch, cudnn_fwd_bwd),
                   "launch": launch}
            emit(row)
            if not err <= tol:
                raise AssertionError("lstm_seq_bwd disagrees with its plain "
                                     "version: %r" % row)
            if chunked and launch["launches"] < 2:
                raise AssertionError("lstm_seq_bwd at B=%d, H=%d did not run "
                                     "as row chunks: %r" % (batch, hidden,
                                                            row))
            if not chunked:
                results.append(row)
    return results


def gru_bound_ms(steps, batch, hidden, dtype_name, backward=False):
    """Least time for the GRU forward (backward): the bytes it must move
    (forward: proj, mask, w_rz, w_c, h0 read once, h_seq written once;
    backward: proj, mask, w_rz, w_c, hprev, dh_seq, dh_f read once, dproj
    and dh0 written once) over HBM rate, or its recurrent GEMV FLOPs
    (2*T*B*H*3H forward, twice that backward) over the peak rate for the
    dtype, whichever is larger."""
    isz = 2 if dtype_name == "bfloat16" else 4
    g3 = 3 * hidden
    seq, rows = steps * batch, batch * hidden
    if backward:
        nbytes = (2 * seq * g3 * isz + seq * 4 + hidden * g3 * isz
                  + 2 * seq * hidden * isz + 2 * rows * isz)
    else:
        nbytes = (seq * g3 * isz + seq * 4 + hidden * g3 * isz + rows * isz
                  + seq * hidden * isz)
    flops = (2 if backward else 1) * 2.0 * seq * hidden * g3
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gru_inputs(torch, steps, batch, hidden, dtype, seed):
    """Numpy-seeded GRU inputs: lengths that include T, 0 and 1 (as far
    as the batch allows), nonzero h0, update and reset weights drawn
    independently."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, steps + 1, batch)
    lens[:3] = (steps, 0, 1)[:batch]
    mask = (np.arange(steps)[:, None] < lens[None, :]).astype(np.float32)

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=DEVICE)

    return (dev(rng.randn(steps, batch, 3 * hidden) * 0.5),
            dev(mask, torch.float32),
            dev(rng.randn(hidden, 2 * hidden) / np.sqrt(hidden)),
            dev(rng.randn(hidden, hidden) / np.sqrt(hidden)),
            dev(rng.randn(batch, hidden) * 0.5))


def phase_kernel_gru(torch, gk):
    results = []
    for steps, batch, hidden in GRU_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            args = gru_inputs(torch, steps, batch, hidden, dtype,
                              SEED + 3 * batch + hidden)
            h_k = gk.gru_seq_fwd(*args)
            torch.cuda.synchronize()
            launch = dict(gk.gru_seq_fwd.last_launch)
            err = bwd_error([h_k], [gk.gru_seq_fwd_reference(*args)])
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
            ms = time_ms(torch, lambda: gk.gru_seq_fwd(*args))
            plain_ms = time_ms(torch,
                               lambda: gk.gru_seq_fwd_reference(*args),
                               warmup=1)
            cudnn = torch.nn.GRU(hidden, hidden).to(DEVICE, dtype)
            cudnn.flatten_parameters()
            x = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype)
            with torch.no_grad():
                cudnn_ms = time_ms(torch, lambda: cudnn(x))
            bound, bound_by = gru_bound_ms(steps, batch, hidden, name)
            row = {"phase": "kernel_gru", "kernel": "gru_seq_fwd",
                   "T": steps, "B": batch, "H": hidden, "dtype": name,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by,
                   "cudnn_gru_ms_not_same_function": cudnn_ms,
                   "launch": launch}
            emit(row)
            if not err <= tol:
                raise AssertionError("gru_seq_fwd disagrees with its plain "
                                     "version: %r" % row)
            results.append(row)
    return results


def phase_kernel_gru_bwd(torch, gk):
    results = []
    for steps, batch, hidden in GRU_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            seed = SEED + 5 * batch + hidden
            proj, mask, w_rz, w_c, h0 = gru_inputs(torch, steps, batch,
                                                   hidden, dtype, seed)
            h_seq = gk.gru_seq_fwd_reference(proj, mask, w_rz, w_c, h0)
            rng = np.random.RandomState(seed + 1)
            args = (proj, mask, w_rz, w_c, torch.cat([h0[None], h_seq[:-1]]),
                    torch.tensor(rng.randn(steps, batch, hidden) * 0.5,
                                 dtype=dtype, device=DEVICE),
                    torch.tensor(rng.randn(batch, hidden) * 0.5, dtype=dtype,
                                 device=DEVICE))
            got = gk.gru_seq_bwd(*args)
            torch.cuda.synchronize()
            launch = dict(gk.gru_seq_bwd.last_launch)
            err = bwd_error(got, gk.gru_seq_bwd_reference(*args))
            tol = TOL_BWD[name]
            ms = time_ms(torch, lambda: gk.gru_seq_bwd(*args))
            plain_ms = time_ms(torch,
                               lambda: gk.gru_seq_bwd_reference(*args),
                               warmup=1, reps=5)
            cudnn = torch.nn.GRU(hidden, hidden).to(DEVICE, dtype)
            cudnn.flatten_parameters()
            x = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype,
                            requires_grad=True)
            dy = torch.randn(steps, batch, hidden, device=DEVICE, dtype=dtype)

            def cudnn_fwd_bwd():
                cudnn(x)[0].backward(dy)

            bound, bound_by = gru_bound_ms(steps, batch, hidden, name,
                                           backward=True)
            row = {"phase": "kernel_gru_bwd", "kernel": "gru_seq_bwd",
                   "T": steps, "B": batch, "H": hidden, "dtype": name,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by,
                   "cudnn_gru_fwd_bwd_ms_not_same_function":
                       time_ms(torch, cudnn_fwd_bwd),
                   "launch": launch}
            emit(row)
            if not err <= tol:
                raise AssertionError("gru_seq_bwd disagrees with its plain "
                                     "version: %r" % row)
            results.append(row)
    return results


def numpy_params(topology, seed):
    """Every parameter from a numpy seed: weights N(0, 1/fan_in), biases
    and peephole checks N(0, 0.1^2)."""
    import torch

    from paddle_tpu_torch.parameters import Parameters

    rng = np.random.RandomState(seed)
    values = {}
    for name, spec in sorted(topology.param_specs().items()):
        fan_in = getattr(spec.initializer, "fan_in", None)
        std = 1.0 / np.sqrt(fan_in) if fan_in else 0.1
        values[name] = torch.from_numpy(
            (rng.standard_normal(spec.shape) * std).astype(np.float32))
    return Parameters(values)


def random_request(rng, rows, seq_len, vocab):
    lens = rng.randint(0, seq_len + 1, rows).astype(np.int32)
    return {"word": rng.randint(0, vocab, (rows, seq_len)).astype(np.int32),
            "word:lens": lens}


def export(tmp, sub, kwargs, batch_sizes, seq_len, builder=BUILDER):
    from paddle_tpu_torch.serve.bundle import build_outputs
    from paddle_tpu_torch.serve.export import export_bundle, parse_builder
    from paddle_tpu_torch.topology import Topology

    builder = parse_builder(builder, kwargs)
    params = numpy_params(Topology(build_outputs(builder)), SEED)
    out_dir = os.path.join(tmp, sub)
    export_bundle(builder, params, out_dir, batch_sizes=batch_sizes,
                  seq_len=seq_len)
    return out_dir


def check_close(got, want, what):
    err = float(np.abs(got - want).max())
    if not (np.all(np.isfinite(got)) and got.shape == want.shape
            and err <= TOL_SERVE):
        raise AssertionError("%s: card vs CPU max |err| %g (shapes %s, %s)"
                             % (what, err, got.shape, want.shape))
    return err


def run_burst(engine, burst):
    """Submit ``burst`` from as many client threads at once; returns the
    answers, each request's latency (ms) and the burst's wall time (s)."""
    results = [None] * len(burst)
    gate = threading.Barrier(len(burst) + 1)

    def client(i):
        gate.wait()
        t_sub = time.perf_counter()
        out = engine.infer(burst[i], timeout=300)
        results[i] = (out, t_sub, time.perf_counter())

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(len(burst))]
    for c in clients:
        c.start()
    gate.wait()
    t0 = time.perf_counter()
    for c in clients:
        c.join(timeout=300)
    if any(r is None for r in results):
        raise AssertionError("a burst request did not complete")
    wall = max(r[2] for r in results) - t0
    return ([r[0] for r in results],
            [(r[2] - r[1]) * 1e3 for r in results], wall)


def post_infer(url, req):
    """POST /infer with ``req``; returns the decoded outputs."""
    body = json.dumps({"inputs": {k: v.tolist()
                                  for k, v in req.items()}}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            url + "/infer", data=body,
            headers={"Content-Type": "application/json"})) as fh:
        return json.loads(fh.read())["outputs"]


def phase_serve_flagship(torch, lk, tmp):
    from paddle_tpu_torch.serve import (InferenceEngine, load_bundle,
                                        serve_in_thread)

    bundle_dir = export(tmp, "flagship", FLAGSHIP, (1, 8, 32), 64)
    cpu = load_bundle(bundle_dir, device="cpu")
    bundle = load_bundle(bundle_dir, device=DEVICE)
    rng = np.random.RandomState(SEED)
    seq_len, vocab = bundle.seq_len, FLAGSHIP["dict_size"]
    lk.reset_launches()  # the main path starts here (engine warmup included)
    engine = InferenceEngine(bundle, max_batch_size=32, max_latency_ms=10.0)
    server = thread = None
    errs = []
    try:
        # a burst of 16 concurrent requests (flushes on size), then single
        # requests spaced past the deadline (flushes on deadline)
        burst = [random_request(rng, int(rng.randint(1, 9)), seq_len, vocab)
                 for _ in range(16)]
        outs, latencies, wall = run_burst(engine, burst)
        for req, out in zip(burst, outs):
            errs.append(check_close(out["lstm_out"],
                                    cpu.infer(req)["lstm_out"], "burst"))
        for _ in range(4):
            req = random_request(rng, int(rng.randint(1, 9)), seq_len, vocab)
            t_sub = time.perf_counter()
            out = engine.infer(req, timeout=300)
            latencies.append((time.perf_counter() - t_sub) * 1e3)
            errs.append(check_close(out["lstm_out"],
                                    cpu.infer(req)["lstm_out"], "single"))
        server, thread = serve_in_thread(bundle, engine)
        url = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(url + "/readyz") as fh:
            ready = json.loads(fh.read())
        for _ in range(3):
            req = random_request(rng, int(rng.randint(1, 5)), seq_len, vocab)
            errs.append(check_close(
                np.asarray(post_infer(url, req)["lstm_out"], np.float32),
                cpu.infer(req)["lstm_out"], "http"))
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()
    launches = lk.launches
    stats = engine.stats()
    dispatched = stats["warmup_batches"] + stats["batches"]
    row = {"phase": "serve_flagship", "config": FLAGSHIP, "seq_len": seq_len,
           "buckets": bundle.batch_sizes(), "requests": stats["requests"],
           "rows": stats["rows"], "batches": stats["batches"],
           "warmup_batches": stats["warmup_batches"],
           "flush_on_size": stats["flush_on_size"],
           "flush_on_deadline": stats["flush_on_deadline"],
           "kernel_launches": launches,
           "max_abs_err_vs_cpu": max(errs), "readyz": ready,
           "burst_qps": len(burst) / wall,
           "latency_ms_p50": float(np.percentile(latencies, 50)),
           "latency_ms_p99": float(np.percentile(latencies, 99))}
    emit(row)
    if launches != 2 * dispatched:
        raise AssertionError("lstm_seq_fwd launched %d times for %d "
                             "dispatched batches of a 2-LSTM model"
                             % (launches, dispatched))
    if not (stats["flush_on_size"] >= 1 and stats["flush_on_deadline"] >= 1
            and stats["batches_failed"] == 0 and ready["ready"]):
        raise AssertionError("engine flush policy not exercised: %r" % stats)
    return row


def phase_serve_wide(torch, lk, tmp):
    from paddle_tpu_torch.serve import InferenceEngine, load_bundle

    kwargs = dict(FLAGSHIP, hidden=1280)
    bundle_dir = export(tmp, "h1280", kwargs, (64,), 100)
    cpu = load_bundle(bundle_dir, device="cpu")
    bundle = load_bundle(bundle_dir, device=DEVICE)
    rng = np.random.RandomState(SEED + 1)
    req = random_request(rng, 64, bundle.seq_len, kwargs["dict_size"])
    lk.reset_launches()
    engine = InferenceEngine(bundle, max_batch_size=64, max_latency_ms=5.0)
    try:
        t0 = time.perf_counter()
        out = engine.infer(req, timeout=300)["lstm_out"]
        request_ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine.stop()
    launches = lk.launches
    stats = engine.stats()
    head = {k: v[:8] for k, v in req.items()}
    err = check_close(out[:8], cpu.run(head, 8)["lstm_out"], "h1280")
    row = {"phase": "serve_h1280", "config": kwargs,
           "seq_len": bundle.seq_len, "rows": 64, "request_ms": request_ms,
           "kernel_launches": launches, "max_abs_err_vs_cpu": err}
    emit(row)
    dispatched = stats["warmup_batches"] + stats["batches"]
    if launches != 2 * dispatched:
        raise AssertionError("lstm_seq_fwd launched %d times for %d "
                             "dispatched batches" % (launches, dispatched))
    return row


def tagger_request(rng, rows):
    """``rows`` sequences with the lognormal lengths of the tagger's
    serving trace (benchmark/exp_serve.py arrival_trace: median 8, sigma
    0.8, clipped to [1, 128]), padded to seq_len 128."""
    lens = np.clip(np.rint(rng.lognormal(np.log(8.0), 0.8, rows)), 1,
                   TAGGER_SEQ).astype(np.int32)
    return {"word": rng.randint(0, TAGGER["dict_size"],
                                (rows, TAGGER_SEQ)).astype(np.int32),
            "word:lens": lens}


def phase_serve_tagger(torch, gk, tmp):
    from paddle_tpu_torch.serve import (InferenceEngine, load_bundle,
                                        serve_in_thread)

    bundle_dir = export(tmp, "tagger", TAGGER, (1, 8, 32), TAGGER_SEQ,
                        TAGGER_BUILDER)
    cpu = load_bundle(bundle_dir, device="cpu")
    bundle = load_bundle(bundle_dir, device=DEVICE)
    rng = np.random.RandomState(SEED + 8)
    gk.reset_launches()  # the main path starts here (engine warmup included)
    engine = InferenceEngine(bundle, max_batch_size=32, max_latency_ms=10.0)
    server = thread = None
    errs = []
    try:
        burst = [tagger_request(rng, int(rng.randint(1, 9)))
                 for _ in range(16)]
        outs, latencies, wall = run_burst(engine, burst)
        for req, out in zip(burst, outs):
            errs.append(check_close(out["gru_tag_out"],
                                    cpu.infer(req)["gru_tag_out"], "burst"))
        server, thread = serve_in_thread(bundle, engine)
        url = "http://127.0.0.1:%d" % server.server_address[1]
        for _ in range(3):
            req = tagger_request(rng, int(rng.randint(1, 9)))
            errs.append(check_close(
                np.asarray(post_infer(url, req)["gru_tag_out"], np.float32),
                cpu.infer(req)["gru_tag_out"], "http"))
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()
    launches = gk.launches
    stats = engine.stats()
    dispatched = stats["warmup_batches"] + stats["batches"]
    row = {"phase": "serve_tagger", "config": TAGGER, "seq_len": TAGGER_SEQ,
           "buckets": bundle.batch_sizes(), "requests": stats["requests"],
           "rows": stats["rows"], "batches": stats["batches"],
           "warmup_batches": stats["warmup_batches"],
           "flush_on_size": stats["flush_on_size"],
           "flush_on_deadline": stats["flush_on_deadline"],
           "kernel_launches": launches,
           "last_launch": gk.gru_seq_fwd.last_launch,
           "max_abs_err_vs_cpu": max(errs), "burst_qps": len(burst) / wall,
           "latency_ms_p50": float(np.percentile(latencies, 50)),
           "latency_ms_p99": float(np.percentile(latencies, 99))}
    emit(row)
    if launches != dispatched:
        raise AssertionError("gru_seq_fwd launched %d times for %d "
                             "dispatched batches of a 1-GRU model"
                             % (launches, dispatched))
    if stats["batches_failed"] != 0:
        raise AssertionError("tagger batches failed: %r" % stats)
    return row


class Batch(list):
    """A minibatch padded to ``bucket`` steps (the trainer reads it)."""

    def __init__(self, rows, bucket=TRAIN_SEQ):
        super().__init__(rows)
        self.bucket = bucket


def train_batches(seed, n, rows, ragged, vocab):
    """``n`` minibatches of (ids, label): lengths in [0, 100] including 0, 1
    and 100 when ``ragged``, else all 100 (the bench rows' traffic)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = (rng.randint(0, TRAIN_SEQ + 1, rows) if ragged
                else np.full(rows, TRAIN_SEQ))
        if ragged:
            lens[:3] = (TRAIN_SEQ, 0, 1)
        out.append(Batch((rng.randint(0, vocab, int(k)).tolist(),
                          int(rng.randint(0, 2))) for k in lens))
    return out


def tagger_batches(seed, n, rows, ragged):
    """``n`` minibatches of (ids, labels) padded to 128 steps: lengths in
    [0, 128] including 0, 1 and 128 when ``ragged``, else all 128."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = (rng.randint(0, TAGGER_SEQ + 1, rows) if ragged
                else np.full(rows, TAGGER_SEQ))
        if ragged:
            lens[:3] = (TAGGER_SEQ, 0, 1)
        out.append(Batch(((rng.randint(0, TAGGER["dict_size"], int(k))
                           .tolist(),
                           rng.randint(0, TAGGER["label_size"], int(k))
                           .tolist()) for k in lens), bucket=TAGGER_SEQ))
    return out


class TrainRig:
    """A model's output plus a label and classification_cost, its cost
    topology and numpy-seeded initial parameters (``params(topology,
    seed)``, default numpy_params); ``trainer(device)``
    gives a fresh trainer with Momentum(learning_rate, 0.9) on its own
    copy of them."""

    def __init__(self, build, config, label_type, seed, learning_rate,
                 params=None):
        from paddle_tpu_torch import layer
        from paddle_tpu_torch.graph import reset_name_counters
        from paddle_tpu_torch.topology import Topology

        reset_name_counters()
        self.config = config
        self.learning_rate = learning_rate
        self.out = build(**config)
        label = layer.data(name="label", type=label_type)
        self.cost = layer.classification_cost(input=self.out, label=label)
        self.topology = Topology(self.cost)
        self.init = (params or numpy_params)(self.topology, seed)

    def trainer(self, device):
        from paddle_tpu_torch import optimizer, trainer
        from paddle_tpu_torch.parameters import Parameters

        params = Parameters({k: v.clone()
                             for k, v in self.init.as_dict().items()},
                            self.topology.param_specs())
        return trainer.SGD(self.cost, params, optimizer.Momentum(
            learning_rate=self.learning_rate, momentum=0.9), device=device)


def flagship_rig(hidden, seed):
    from paddle_tpu_torch import data_type
    from paddle_tpu_torch.models.text import text_classification_lstm

    return TrainRig(text_classification_lstm, dict(FLAGSHIP, hidden=hidden),
                    data_type.integer_value(2), seed, 0.01)


def train(torch, tr, batches, timed=False):
    """Run ``batches`` through ``tr.train``; returns the per-step costs and,
    with ``timed``, the median ms between consecutive steps, each ended by
    a synchronize (the first step, which builds caches, is left out)."""
    from paddle_tpu_torch.event import EndIteration

    costs, stamps = [], []

    def handler(evt):
        if isinstance(evt, EndIteration):
            if timed:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            costs.append(evt.cost)

    tr.train(lambda: iter(batches), event_handler=handler)
    if not timed:
        return costs
    return costs, statistics.median(np.diff(stamps) * 1e3)


def profile_steps(torch, tr, batches, kernels=()):
    """Where a training step's time goes on the card (torch.profiler over
    ``batches``): wall ms per step (profiler on), the kernels' busy ms per
    step (the union of their intervals), the idle share, the largest
    kernels by device time, and for each name fragment in ``kernels`` the
    device ms per step of the kernels whose names contain it and their
    share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(torch, tr, batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        total, calls = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (total + (end - start) / 1e3, calls + 1)
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    steps = len(batches)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    mine = {}
    for frag in kernels:
        ms = sum(t for name, (t, _) in by_name.items() if frag in name)
        mine[frag] = {"ms_per_step": ms / steps,
                      "share_of_busy": ms * 1e3 / busy_us if busy_us else 0.0}
    return {"steps": steps, "device_events": len(spans), "kernels": mine,
            "wall_ms_per_step": wall_ms / steps,
            "busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "kernels_per_step": len(spans) / steps,
            "top": [{"kernel": name[:100], "ms_per_step": t / steps,
                     "calls_per_step": c / steps}
                    for name, (t, c) in top]}


def param_error(a, b):
    """max over the parameters of max |a - b| (numpy, from Parameters)."""
    return max(float(np.abs(a.get(n) - b.get(n)).max()) for n in a.names())


def check_launches(kernels, steps, per_step, what):
    """The forward and backward launch counts of a kernel module
    (lstm_kernels or gru_kernels) after ``steps`` training steps of a
    model with ``per_step`` such layers."""
    fwd, bwd = kernels.launches, kernels.bwd_launches
    if not (fwd == per_step * steps and bwd == per_step * steps):
        raise AssertionError(
            "%s: %d steps launched the forward kernel %d and the backward "
            "kernel %d times (want %d each)" % (what, steps, fwd, bwd,
                                                per_step * steps))
    return fwd, bwd


def cost_error(got, want):
    """max over the steps of |got - want| / max(1, |want|)."""
    return max(abs(g - w) / max(1.0, abs(w)) for g, w in zip(got, want))


def no_gradient(tr):
    """Parameters of a trainer's last step without a finite nonzero
    gradient."""
    import torch

    return [n for n, p in tr._trainable.items()
            if p.grad is None or not bool(torch.isfinite(p.grad).all())
            or float(p.grad.abs().max()) == 0.0]


def phase_train_flagship(torch, lk, tmp):
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.inference import infer
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import parse_builder

    rig = flagship_rig(256, SEED + 2)
    vocab = FLAGSHIP["dict_size"]
    ragged = train_batches(SEED + 3, 3, TRAIN_BATCH, True, vocab)
    full = train_batches(SEED + 4, TRAIN_STEPS, TRAIN_BATCH, False, vocab)
    # f32 on the card: step 1 alone (its gradients checked), then 2 and 3
    card = rig.trainer(DEVICE)
    lk.reset_launches()
    costs = train(torch, card, ragged[:1])
    no_grad = no_gradient(card)
    costs += train(torch, card, ragged[1:])
    ragged_launches = check_launches(lk, 3, 2, "ragged steps")
    cpu = rig.trainer("cpu")
    cpu_costs = train(torch, cpu, ragged)
    cost_err = float(np.abs(np.subtract(costs, cpu_costs)).max())
    param_err = param_error(card.parameters, cpu.parameters)
    lk.reset_launches()  # the main path: 20 steps at the bench row's traffic
    _, ms = train(torch, card, full, timed=True)
    launches = check_launches(lk, TRAIN_STEPS, 2, "f32 training")
    profile = profile_steps(torch, card, full[:5])
    # the same under the bfloat16 compute policy (float32 masters)
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        card16 = rig.trainer(DEVICE)
        costs16 = train(torch, card16, ragged)
        lk.reset_launches()
        _, ms16 = train(torch, card16, full, timed=True)
        launches16 = check_launches(lk, TRAIN_STEPS, 2, "bf16 training")
    finally:
        dtype_mod.set_mixed_precision(None)
    bf16_err = float(np.abs(np.subtract(costs16, costs)).max())
    # the trained f32 parameters served from a bundle on the card
    bundle_dir = os.path.join(tmp, "trained")
    card.export_inference_bundle(parse_builder(BUILDER, FLAGSHIP),
                                 bundle_dir, batch_sizes=(8,),
                                 seq_len=TRAIN_SEQ)
    bundle = load_bundle(bundle_dir, device=DEVICE)
    req = random_request(np.random.RandomState(SEED + 5), 8, TRAIN_SEQ,
                         vocab)
    rows = [(req["word"][i, :req["word:lens"][i]].tolist(),)
            for i in range(8)]
    served_err = check_close(bundle.infer(req)["lstm_out"],
                             infer(rig.out, card.parameters, rows,
                                   device="cpu"), "trained bundle")
    row = {"phase": "train_flagship", "config": rig.config,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "optimizer": "Momentum(learning_rate=0.01, momentum=0.9)",
           "ragged_costs_card": costs, "ragged_costs_cpu": cpu_costs,
           "cost_err_vs_cpu": cost_err, "param_err_vs_cpu": param_err,
           "tol": TOL_TRAIN, "params_without_gradient": no_grad,
           "ragged_launches": ragged_launches, "steps": TRAIN_STEPS,
           "ms_per_batch_f32": ms, "launches_f32": launches,
           "profile_f32": profile, "bf16_ragged_costs": costs16,
           "bf16_cost_err_vs_f32": bf16_err,
           "tol_bf16": TOL_TRAIN_BF16, "ms_per_batch_bf16": ms16,
           "launches_bf16": launches16,
           "trained_bundle_err_vs_cpu_infer": served_err}
    emit(row)
    if no_grad:
        raise AssertionError("parameters without a finite nonzero gradient "
                             "at step 1: %s" % no_grad)
    if not (cost_err <= TOL_TRAIN and param_err <= TOL_TRAIN):
        raise AssertionError("training on the card departs from the CPU: "
                             "%r" % row)
    if not bf16_err <= TOL_TRAIN_BF16:
        raise AssertionError("bf16 training departs from f32: %r" % row)
    return {"fwd_launches": launches[0], "bwd_launches": launches[1]}


def phase_train_tagger(torch, gk):
    from paddle_tpu_torch import data_type
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.models.text import sequence_tagging_gru

    rig = TrainRig(sequence_tagging_gru, TAGGER,
                   data_type.integer_value_sequence(TAGGER["label_size"]),
                   SEED + 9, 1e-3)
    ragged = tagger_batches(SEED + 10, 3, TRAIN_BATCH, True)
    full = tagger_batches(SEED + 11, TRAIN_STEPS, TRAIN_BATCH, False)
    # f32 on the card: step 1 alone (its gradients checked), then 2 and 3
    card = rig.trainer(DEVICE)
    gk.reset_launches()
    costs = train(torch, card, ragged[:1])
    no_grad = no_gradient(card)
    costs += train(torch, card, ragged[1:])
    ragged_launches = check_launches(gk, 3, 1, "tagger ragged steps")
    cpu = rig.trainer("cpu")
    cpu_costs = train(torch, cpu, ragged)
    cost_err = cost_error(costs, cpu_costs)
    param_err = param_error(card.parameters, cpu.parameters)
    gk.reset_launches()  # the main path: 20 steps at length 128
    _, ms = train(torch, card, full, timed=True)
    launches = check_launches(gk, TRAIN_STEPS, 1, "tagger f32 training")
    profile = profile_steps(torch, card, full[:5])
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        card16 = rig.trainer(DEVICE)
        costs16 = train(torch, card16, ragged)
        gk.reset_launches()
        _, ms16 = train(torch, card16, full, timed=True)
        launches16 = check_launches(gk, TRAIN_STEPS, 1,
                                    "tagger bf16 training")
    finally:
        dtype_mod.set_mixed_precision(None)
    bf16_err = cost_error(costs16, costs)
    row = {"phase": "train_tagger", "config": rig.config,
           "batch": TRAIN_BATCH, "seq_len": TAGGER_SEQ,
           "optimizer": "Momentum(learning_rate=0.001, momentum=0.9)",
           "ragged_costs_card": costs, "ragged_costs_cpu": cpu_costs,
           "cost_err_rel_vs_cpu": cost_err, "param_err_vs_cpu": param_err,
           "tol": TOL_TRAIN, "params_without_gradient": no_grad,
           "ragged_launches": ragged_launches, "steps": TRAIN_STEPS,
           "ms_per_batch_f32": ms, "launches_f32": launches,
           "last_fwd_launch": gk.gru_seq_fwd.last_launch,
           "last_bwd_launch": gk.gru_seq_bwd.last_launch,
           "profile_f32": profile, "bf16_ragged_costs": costs16,
           "bf16_cost_err_rel_vs_f32": bf16_err,
           "tol_bf16": TOL_TRAIN_BF16, "ms_per_batch_bf16": ms16,
           "launches_bf16": launches16}
    emit(row)
    if no_grad:
        raise AssertionError("tagger parameters without a finite nonzero "
                             "gradient at step 1: %s" % no_grad)
    if not (cost_err <= TOL_TRAIN and param_err <= TOL_TRAIN):
        raise AssertionError("tagger training on the card departs from the "
                             "CPU: %r" % row)
    if not bf16_err <= TOL_TRAIN_BF16:
        raise AssertionError("tagger bf16 training departs from f32: %r"
                             % row)
    return {"fwd_launches": launches[0], "bwd_launches": launches[1]}


def grad_error(a, b):
    """max over the parameters of max |a.grad - b.grad| / max |b.grad|."""
    out = 0.0
    for name, p in b._trainable.items():
        ref = p.grad.float()
        diff = (a._trainable[name].grad.float().cpu() - ref).abs().max()
        out = max(out, float(diff) / max(float(ref.abs().max()), 1e-30))
    return out


def phase_train_h1280(torch, lk):
    rig = flagship_rig(1280, SEED + 6)
    vocab = FLAGSHIP["dict_size"]
    full = train_batches(SEED + 7, H1280_STEPS, TRAIN_BATCH, False, vocab)
    card = rig.trainer(DEVICE)
    lk.reset_launches()  # the main path of this width
    _, ms = train(torch, card, full, timed=True)
    launches = check_launches(lk, H1280_STEPS, 2, "h1280 training")
    profile = profile_steps(torch, card, full[:3])
    # one step on the first 8 rows, card against CPU
    head = [Batch(full[0][:8])]
    card8, cpu8 = rig.trainer(DEVICE), rig.trainer("cpu")
    cost_card = train(torch, card8, head)[0]
    cost_cpu = train(torch, cpu8, head)[0]
    cost_err = abs(cost_card - cost_cpu)
    grad_err = grad_error(card8, cpu8)
    row = {"phase": "train_h1280", "config": rig.config,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": H1280_STEPS,
           "ms_per_batch_f32": ms, "launches": launches,
           "profile_f32": profile, "rows8_cost_card": cost_card,
           "rows8_cost_cpu": cost_cpu,
           "rows8_cost_err": cost_err, "rows8_grad_err_rel": grad_err,
           "tol": TOL_TRAIN}
    emit(row)
    if not (cost_err <= TOL_TRAIN and grad_err <= TOL_TRAIN):
        raise AssertionError("h1280 step on the card departs from the CPU: "
                             "%r" % row)
    return {"fwd_launches": launches[0], "bwd_launches": launches[1]}


def conv_bound_ms(nbytes, flops, dtype_name):
    """Least time for a conv-shaped product: ``nbytes`` (each input read
    once, each output written once) over HBM rate, or ``flops`` over the
    peak rate for the dtype, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_inputs(torch, shape, dtype, seed):
    """x [N, H, W, C], w [k, k, C, F] (std 1/sqrt(k*k*C)) and dy
    [N, H, W, F] on the card, from a seeded generator on the card."""
    n, h, w, c, f, k = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*size, scale=1.0):
        return (torch.randn(size, generator=gen, device=DEVICE) * scale
                ).to(dtype)

    return (randn(n, h, w, c, scale=0.5),
            randn(k, k, c, f, scale=1.0 / np.sqrt(k * k * c)),
            randn(n, h, w, f, scale=0.5))


def rel_error(got, want):
    """max |got - want| / max(1, max |want|)."""
    return (float((got.float() - want.float()).abs().max())
            / max(1.0, float(want.float().abs().max())))


def conv_row(phase, kernel, shape, name, err, tol, ms, plain_ms, library_ms,
             nbytes, launch):
    n, h, w, c, f, k = shape
    bound, bound_by = conv_bound_ms(nbytes, 2.0 * n * h * w * k * k * c * f,
                                    name)
    row = {"phase": phase, "kernel": kernel, "shape": list(shape),
           "dtype": name, "max_abs_err": err, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound, "bound_by": bound_by,
           "tflops": 2.0 * n * h * w * k * k * c * f / ms / 1e9,
           "launch": launch}
    emit(row)
    if not err <= tol:
        raise AssertionError("%s disagrees with its plain version: %r"
                             % (kernel, row))
    return row


def phase_kernel_conv(torch, ck):
    """K7 at every stride-1 conv shape of ResNet-50 at batch 64."""
    results = []
    F = torch.nn.functional
    for i, shape in enumerate(CONV_CASES):
        n, h, w, c, f, k = shape
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            isz = 2 if dtype == torch.bfloat16 else 4
            x, wk, _ = conv_inputs(torch, shape, dtype, SEED + 11 * i)
            y = ck.conv2d_same_fwd(x, wk)
            torch.cuda.synchronize()
            launch = dict(ck.conv2d_same_fwd.last_launch)
            err = rel_error(y, ck.conv2d_same_reference(x, wk))
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), wk.permute(3, 2, 0, 1)
            results.append(conv_row(
                "kernel_conv", "conv2d_same_fwd", shape, name, err,
                TOL_CONV[name], time_ms(torch, lambda: ck.conv2d_same_fwd(
                    x, wk)),
                time_ms(torch, lambda: ck.conv2d_same_reference(x, wk),
                        warmup=1, reps=5),
                time_ms(torch, lambda: F.conv2d(x_nchw, w_oihw,
                                                padding=k // 2)),
                (n * h * w * (c + f) + k * k * c * f) * isz, launch))
    return results


def phase_kernel_conv_bwd(torch, ck):
    """The data gradient (K7 on the flipped, transposed weight) and K8 at
    the same shapes; aten.convolution_backward is the library time of
    each."""
    results = []
    backward = torch.ops.aten.convolution_backward
    for i, shape in enumerate(CONV_CASES):
        n, h, w, c, f, k = shape
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            isz = 2 if dtype == torch.bfloat16 else 4
            x, wk, dy = conv_inputs(torch, shape, dtype, SEED + 13 * i)
            w_t = ck.transposed_weight(wk)
            dx = ck.conv2d_same_fwd(dy, w_t)
            torch.cuda.synchronize()
            launch = dict(ck.conv2d_same_fwd.last_launch)
            dw = ck.conv2d_same_bwd_filter(x, dy, k)
            torch.cuda.synchronize()
            launch_w = dict(ck.conv2d_same_bwd_filter.last_launch)
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), wk.permute(3, 2, 0, 1)
            dy_nchw = dy.permute(0, 3, 1, 2)

            def library(mask):
                return backward(dy_nchw, x_nchw, w_oihw, None, [1, 1],
                                [k // 2, k // 2], [1, 1], False, [0, 0], 1,
                                mask)

            results.append(conv_row(
                "kernel_conv_bwd", "conv2d_same_fwd[data_gradient]", shape,
                name, rel_error(dx, ck.conv2d_same_reference(dy, w_t)),
                TOL_CONV[name],
                time_ms(torch, lambda: ck.conv2d_same_fwd(
                    dy, ck.transposed_weight(wk))),
                time_ms(torch, lambda: ck.conv2d_same_reference(
                    dy, ck.transposed_weight(wk)), warmup=1, reps=5),
                time_ms(torch, lambda: library([True, False, False])),
                (n * h * w * (c + f) + k * k * c * f) * isz, launch))
            results.append(conv_row(
                "kernel_conv_bwd", "conv2d_same_bwd_filter", shape, name,
                rel_error(dw, ck.conv2d_same_bwd_filter_reference(x, dy, k)),
                TOL_CONV_BWDW,
                time_ms(torch, lambda: ck.conv2d_same_bwd_filter(x, dy, k)),
                time_ms(torch, lambda: ck.conv2d_same_bwd_filter_reference(
                    x, dy, k), warmup=1, reps=5),
                time_ms(torch, lambda: library([False, True, False])),
                n * h * w * (c + f) * isz + k * k * c * f * 4, launch_w))
    return results


def network_sum(cases, which):
    """One float32 row for the 46 stride-1 convs of a ResNet-50 forward
    (``which`` "fwd"), their data gradients ("dgrad") or filter gradients
    ("bwdw") at batch 64: each shape's numbers times its count in the
    network, summed."""
    kernel = {"fwd": "conv2d_same_fwd",
              "dgrad": "conv2d_same_fwd[data_gradient]",
              "bwdw": "conv2d_same_bwd_filter"}[which]
    rows = {tuple(c["shape"]): c for c in cases
            if c["kernel"] == kernel and c["dtype"] == "float32"}
    out = {"dtype": "float32", "ms": 0.0, "plain_ms": 0.0,
           "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "shape": "ResNet-50 at batch 64, 224x224: the 46 stride-1 convs "
                    "of one %s (13 shapes, float32)" % {
                        "fwd": "forward", "dgrad": "backward",
                        "bwdw": "backward"}[which]}
    by = {"bytes": 0.0, "operations": 0.0}
    for k, c, f, hw, count in RESNET_CONVS:
        row = rows[(RESNET_BATCH, hw, hw, c, f, k)]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            out[key] += count * row[key]
        by[row["bound_by"]] += count * row["bound_ms"]
        out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    out["bound_by"] = max(by, key=by.get)
    return out


def resnet_params(topology, seed, trained_init=False):
    """Every ResNet parameter from a numpy seed: weights N(0, 1/fan_in);
    batch-norm gammas 1 + N(0, 0.1^2), betas and moving means N(0, 0.1^2),
    moving variances 1 + U(0, 0.5) (served statistics), or the
    initialisers' 1, 0, 0, 1 (``trained_init``)."""
    import torch

    from paddle_tpu_torch.parameters import Parameters

    rng = np.random.RandomState(seed)
    values = {}
    for name, spec in sorted(topology.param_specs().items()):
        shape = spec.shape
        if name.endswith(".moving_var"):
            v = (np.ones(shape) if trained_init
                 else 1 + 0.5 * rng.random_sample(shape))
        elif name.endswith(".moving_mean") or "_bn.wbias" in name:
            v = np.zeros(shape) if trained_init else 0.1 * rng.randn(*shape)
        elif "_bn.w0" in name:
            v = np.ones(shape) if trained_init else 1 + 0.1 * rng.randn(
                *shape)
        elif name.endswith(".wbias"):
            v = 0.1 * rng.randn(*shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        values[name] = torch.from_numpy(v.astype(np.float32))
    return Parameters(values, topology.param_specs())


def resnet_images(rng, rows):
    """``rows`` flat NCHW images N(0, 1) from a numpy Generator (as
    benchmark/harness.py feeds the vision bench row random pixels)."""
    return rng.standard_normal((rows, RESNET_PIXELS), dtype=np.float32)


def phase_serve_resnet(torch, ck, tmp):
    from paddle_tpu_torch.serve import (InferenceEngine, load_bundle,
                                        serve_in_thread)
    from paddle_tpu_torch.serve.bundle import build_outputs
    from paddle_tpu_torch.serve.export import export_bundle, parse_builder
    from paddle_tpu_torch.topology import Topology

    builder = parse_builder(RESNET_BUILDER, RESNET)
    bundle_dir = os.path.join(tmp, "resnet")
    export_bundle(builder, resnet_params(Topology(build_outputs(builder)),
                                         SEED + 20),
                  bundle_dir, batch_sizes=(1, 8, 32))
    bundle = load_bundle(bundle_dir, device=DEVICE)
    rng = np.random.default_rng(SEED + 21)
    ck.reset_launches()  # the main path starts here (engine warmup included)
    engine = InferenceEngine(bundle, max_batch_size=32, max_latency_ms=10.0)
    server = thread = None
    reqs, got = [], []
    try:
        burst = [{"image": resnet_images(rng, int(rng.integers(1, 5)))}
                 for _ in range(8)]
        outs, latencies, wall = run_burst(engine, burst)
        reqs += burst
        got += [o["res_out"] for o in outs]
        server, thread = serve_in_thread(bundle, engine)
        url = "http://127.0.0.1:%d" % server.server_address[1]
        for _ in range(2):
            req = {"image": resnet_images(rng, 1)}
            reqs.append(req)
            got.append(np.asarray(post_infer(url, req)["res_out"],
                                  np.float32))
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()
    launches = ck.launches
    stats = engine.stats()
    # the CPU answers in one batch: test-mode rows are independent
    rows = np.concatenate([r["image"] for r in reqs])
    cpu = load_bundle(bundle_dir, device="cpu")
    want = cpu.run({"image": rows}, len(rows))["res_out"]
    err = check_close(np.concatenate(got), want, "resnet50 served")
    dispatched = stats["warmup_batches"] + stats["batches"]
    row = {"phase": "serve_resnet", "config": RESNET,
           "buckets": bundle.batch_sizes(), "requests": stats["requests"],
           "rows": stats["rows"], "batches": stats["batches"],
           "warmup_batches": stats["warmup_batches"],
           "kernel_launches": launches, "max_abs_err_vs_cpu": err,
           "burst_images_per_s": sum(len(r["image"]) for r in burst) / wall,
           "latency_ms_p50": float(np.percentile(latencies, 50)),
           "latency_ms_max": float(np.max(latencies))}
    emit(row)
    if launches != 46 * dispatched:
        raise AssertionError("conv2d_same_fwd launched %d times for %d "
                             "dispatched batches of ResNet-50 (46 each)"
                             % (launches, dispatched))
    if stats["batches_failed"] != 0:
        raise AssertionError("resnet batches failed: %r" % stats)
    return row


def resnet_batches(seed, n, rows):
    """``n`` minibatches of ``rows`` (image, label) pairs from a seed."""
    rng = np.random.default_rng(seed)
    return [[(img, int(label)) for img, label in zip(
        resnet_images(rng, rows),
        rng.integers(0, RESNET["num_classes"], rows))]
        for _ in range(n)]


def tensor_errors(a, b, names):
    """{name: max |a - b| / max |b|} (each tensor divided by its own
    largest entry), Parameters a and b."""
    return {n: float(np.abs(a.get(n) - b.get(n)).max())
            / max(float(np.abs(b.get(n)).max()), 1e-30) for n in names}


def worst(errors, k=3):
    return sorted(errors.items(), key=lambda kv: -kv[1])[:k]


def update_error(card, cpu, init, names):
    """||card update - CPU update|| / ||CPU update|| over all ``names``
    together: how far the card's step moved the parameters from where the
    CPU's moved them."""
    diff = sum(float(np.square(card.get(n) - cpu.get(n)).sum())
               for n in names)
    ref = sum(float(np.square(cpu.get(n) - init.get(n)).sum())
              for n in names)
    return (diff / ref) ** 0.5


def check_conv_launches(ck, steps, what):
    k7, k8 = ck.launches, ck.bwdw_launches
    if not (k7 == 92 * steps and k8 == 46 * steps):
        raise AssertionError("%s: %d steps launched K7 %d and K8 %d times "
                             "(want %d and %d)" % (what, steps, k7, k8,
                                                   92 * steps, 46 * steps))
    return k7, k8


def phase_train_resnet(torch, ck, tmp):
    from paddle_tpu_torch import data_type
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.inference import infer
    from paddle_tpu_torch.models.vision import resnet
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import parse_builder

    rig = TrainRig(resnet, RESNET,
                   data_type.integer_value(RESNET["num_classes"]), SEED + 22,
                   0.01, params=lambda topo, seed: resnet_params(
                       topo, seed, trained_init=True))
    small = resnet_batches(SEED + 23, 3, 4)
    full = resnet_batches(SEED + 24, RESNET_STEPS, RESNET_BATCH)
    names = rig.init.names()
    state = [n for n in names if ".moving_" in n]
    weights = [n for n in names if n not in state]
    # float32, card and CPU: step 1 alone (its gradients checked), then 2, 3
    card, cpu = rig.trainer(DEVICE), rig.trainer("cpu")
    ck.reset_launches()
    costs = train(torch, card, small[:1])
    no_grad = no_gradient(card)
    cpu_costs = train(torch, cpu, small[:1])
    step1 = {"cost_err_rel": cost_error(costs, cpu_costs),
             "update_err": update_error(card.parameters, cpu.parameters,
                                        rig.init, weights),
             "state_err": max(tensor_errors(card.parameters, cpu.parameters,
                                            state).values()),
             "worst_params": worst(tensor_errors(
                 card.parameters, cpu.parameters, weights))}
    costs += train(torch, card, small[1:])
    cpu_costs += train(torch, cpu, small[1:])
    small_launches = check_conv_launches(ck, 3, "resnet 4-image steps")
    step3 = {"cost_err_rel": cost_error(costs, cpu_costs),
             "update_err": update_error(card.parameters, cpu.parameters,
                                        rig.init, weights),
             "worst_params": worst(tensor_errors(
                 card.parameters, cpu.parameters, weights)),
             "worst_state": worst(tensor_errors(
                 card.parameters, cpu.parameters, state))}
    # the main path: RESNET_STEPS steps at batch 64
    card64 = rig.trainer(DEVICE)
    ck.reset_launches()
    _, ms = train(torch, card64, full, timed=True)
    launches = check_conv_launches(ck, RESNET_STEPS, "resnet f32 training")
    profile = profile_steps(torch, card64, full[:2],
                            kernels=("conv_fwd_kernel", "conv_bwdw"))
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        card16 = rig.trainer(DEVICE)
        ck.reset_launches()
        costs16, ms16 = train(torch, card16, full, timed=True)
        launches16 = check_conv_launches(ck, RESNET_STEPS,
                                         "resnet bf16 training")
    finally:
        dtype_mod.set_mixed_precision(None)
    # the 4-image-trained parameters and statistics served from a bundle
    bundle_dir = os.path.join(tmp, "resnet_trained")
    card.export_inference_bundle(parse_builder(RESNET_BUILDER, RESNET),
                                 bundle_dir, batch_sizes=(2,))
    bundle = load_bundle(bundle_dir, device=DEVICE)
    images = resnet_images(np.random.default_rng(SEED + 25), 2)
    served_err = check_close(
        bundle.infer({"image": images})["res_out"],
        infer(rig.out, card.parameters, [(r,) for r in images],
              device="cpu"), "trained resnet bundle")
    moved = [n for n in state if np.array_equal(
        card.parameters.get(n), rig.init.get(n))]
    row = {"phase": "train_resnet", "config": RESNET,
           "optimizer": "Momentum(learning_rate=0.01, momentum=0.9)",
           "small_costs_card": costs, "small_costs_cpu": cpu_costs,
           "step1_vs_cpu": step1, "step3_vs_cpu": step3,
           "tol": TOL_TRAIN, "tol_update": TOL_TRAIN_RESNET_UPDATE,
           "tol_cost_3_steps": TOL_TRAIN_RESNET_COST,
           "params_without_gradient": no_grad,
           "small_launches": small_launches, "batch": RESNET_BATCH,
           "steps": RESNET_STEPS, "ms_per_batch_f32": ms,
           "images_per_s_f32": RESNET_BATCH / ms * 1e3,
           "launches_f32": launches, "profile_f32": profile,
           "ms_per_batch_bf16": ms16,
           "images_per_s_bf16": RESNET_BATCH / ms16 * 1e3,
           "bf16_costs": costs16, "launches_bf16": launches16,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "trained_bundle_err_vs_cpu_infer": served_err,
           "statistics_not_updated": moved}
    emit(row)
    if no_grad:
        raise AssertionError("resnet parameters without a finite nonzero "
                             "gradient at step 1: %s" % no_grad)
    if not (step1["cost_err_rel"] <= TOL_TRAIN
            and step1["state_err"] <= TOL_TRAIN
            and step1["update_err"] <= TOL_TRAIN_RESNET_UPDATE
            and step3["cost_err_rel"] <= TOL_TRAIN_RESNET_COST):
        raise AssertionError("resnet training on the card departs from the "
                             "CPU: %r" % row)
    if moved or not np.all(np.isfinite(costs16)):
        raise AssertionError("resnet: statistics not updated or bf16 costs "
                             "not finite: %r" % row)
    return {"k7_launches": launches[0], "k8_launches": launches[1]}


def kernel_entry(cases, name, replaces, launches, source, select=None,
                 pick=None):
    """The kernels-line entry for one TPU kernel: the numbers of the
    float32 case ``pick`` chooses (default: the first) among the float32
    cases ``select`` keeps (default: all); max_abs_err is the largest over
    those cases."""
    f32 = [c for c in cases if c["dtype"] == "float32"
           and (select is None or select(c))]
    main = pick(f32) if pick else f32[0]
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/%s.cu" % source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"), "shape": main["shape"]}


def recurrent_entry(cases, name, replaces, launches, hidden, source,
                    batch=None):
    """kernel_entry of a recurrent kernel: its cases at ``hidden``, the
    numbers of the batch the main path runs (default: the widest)."""
    cases = [dict(c, shape=[c["T"], c["B"], c["H"]]) for c in cases]
    return kernel_entry(
        cases, name, replaces, launches, source,
        select=lambda c: c["H"] == hidden,
        pick=lambda f32: (max(f32, key=lambda c: c["B"]) if batch is None
                          else next(c for c in f32 if c["B"] == batch)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import conv_kernels as ck
    from paddle_tpu_torch.ops import gru_kernels as gk
    from paddle_tpu_torch.ops import lstm_kernels as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    libs = _build.build_all(["lstm_seq_fwd", "lstm_seq_bwd", "gru_seq_fwd",
                             "gru_seq_bwd", "conv2d_same_fwd",
                             "conv2d_same_bwdw"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.basename(lib) for lib in libs],
          "ptxas": {k: [ln for ln in v.splitlines() if "Used" in ln]
                    for k, v in _build.build_logs.items()}})

    cases = phase_kernel(torch, lk)
    bwd_cases = phase_kernel_bwd(torch, lk)
    gru_cases = phase_kernel_gru(torch, gk)
    gru_bwd_cases = phase_kernel_gru_bwd(torch, gk)
    conv_cases = phase_kernel_conv(torch, ck)
    conv_bwd_cases = phase_kernel_conv_bwd(torch, ck)
    with tempfile.TemporaryDirectory() as tmp:
        flagship = phase_serve_flagship(torch, lk, tmp)
        wide = phase_serve_wide(torch, lk, tmp)
        trained = phase_train_flagship(torch, lk, tmp)
        tagger = phase_serve_tagger(torch, gk, tmp)
        served_resnet = phase_serve_resnet(torch, ck, tmp)
        trained_resnet = phase_train_resnet(torch, ck, tmp)
    trained_tagger = phase_train_tagger(torch, gk)
    trained_wide = phase_train_h1280(torch, lk)

    emit({"kernels": [
        recurrent_entry(cases, "lstm_seq_fwd[K1,h256]",
                        "paddle_tpu/ops/pallas_kernels.py:146",
                        flagship["kernel_launches"], 256, "lstm_seq_fwd"),
        recurrent_entry(cases, "lstm_seq_fwd[K3,h1280]",
                        "paddle_tpu/ops/pallas_kernels.py:244",
                        wide["kernel_launches"], 1280, "lstm_seq_fwd"),
        recurrent_entry(bwd_cases, "lstm_seq_bwd[K2,h256]",
                        "paddle_tpu/ops/pallas_kernels.py:347",
                        trained["bwd_launches"], 256, "lstm_seq_bwd"),
        recurrent_entry(bwd_cases, "lstm_seq_bwd[K4,h1280]",
                        "paddle_tpu/ops/pallas_kernels.py:456",
                        trained_wide["bwd_launches"], 1280, "lstm_seq_bwd"),
        recurrent_entry(gru_cases, "gru_seq_fwd[K5,h256]",
                        "paddle_tpu/ops/pallas_kernels.py:668",
                        tagger["kernel_launches"], 256, "gru_seq_fwd",
                        batch=32),
        recurrent_entry(gru_bwd_cases, "gru_seq_bwd[K6,h256]",
                        "paddle_tpu/ops/pallas_kernels.py:724",
                        trained_tagger["bwd_launches"], 256, "gru_seq_bwd"),
        kernel_entry([network_sum(conv_cases, "fwd")],
                     "conv2d_same_fwd[K7,resnet50_forward]",
                     "paddle_tpu/ops/pallas_conv.py:175",
                     served_resnet["kernel_launches"], "conv2d_same_fwd"),
        kernel_entry([network_sum(conv_bwd_cases, "dgrad")],
                     "conv2d_same_fwd[K7,resnet50_data_gradient]",
                     "paddle_tpu/ops/pallas_conv.py:175",
                     trained_resnet["k7_launches"], "conv2d_same_fwd"),
        kernel_entry([network_sum(conv_bwd_cases, "bwdw")],
                     "conv2d_same_bwd_filter[K8,resnet50_filter_gradient]",
                     "paddle_tpu/ops/pallas_conv.py:226",
                     trained_resnet["k8_launches"], "conv2d_same_bwdw")]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
