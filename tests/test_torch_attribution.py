"""The trace readers of the port's ``observe/attribution.py`` against the
JAX package's (``paddle_tpu/observe/attribution.py``) on the CPU:

* ``parse_trace_files`` over a JAX-layout trace (the ``XLA Ops`` track
  named by thread-name metadata) and a torch-layout trace (``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events) of the same (name, ts, dur)
  events gives the same ``per_op_us`` and ``calls`` in both parsers;
  gzip, several files, ``parse_trace_dir``'s file patterns, a CPU-only
  torch.profiler trace;
* ``classify`` on kernel names the H100 printed in ``chip_smoke.py``'s
  profiles, the JAX tags where a counterpart exists;
* ``class_report`` and ``report_text`` on synthetic traces whose kernels
  fall in the same classes as the JAX ops;
* ``device_busy_ms`` is None on the CPU in both packages, and
  ``profile_bundle`` runs its untimed step and writes the carry back.
"""

import collections
import gzip
import json
import os
import types

import numpy as np
import pytest
import torch

from paddle_tpu.observe import attribution as jattr

from paddle_tpu_torch.observe import attribution as attr
from paddle_tpu_torch.utils import stat

# (name, ts_us, dur_us): dyadic times, so sums are exact in both parsers
EVENTS = [("fusion.1", 0.0, 12.5), ("copy.3", 20.0, 4.25),
          ("fusion.1", 30.0, 12.5), ("convolution.2", 50.0, 100.0),
          ("copy.3", 160.0, 4.25), ("all-reduce.7", 170.0, 8.0)]
TORCH_CATEGORIES = {"fusion.1": "kernel", "copy.3": "gpu_memcpy",
                    "convolution.2": "kernel", "all-reduce.7": "gpu_memset"}


def jax_layout(events, pid=7):
    meta = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
             "args": {"name": "XLA Modules"}},
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": 2,
             "args": {"name": "XLA Ops"}},
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": 3,
             "args": {"name": "python"}}]
    ops = [{"ph": "X", "pid": pid, "tid": 2, "name": n, "ts": ts, "dur": d}
           for n, ts, d in events]
    host = [{"ph": "X", "pid": pid, "tid": 3, "name": "host", "ts": 0.0,
             "dur": 500.0}]
    return {"traceEvents": meta + ops + host}


def torch_layout(events):
    """The layout torch.profiler's export_chrome_trace writes: device
    events carry their category; host ops, runtime calls, flows and GPU
    annotations are there too and are not the card's work."""
    dev = [{"ph": "X", "cat": TORCH_CATEGORIES.get(n, "kernel"), "name": n,
            "pid": 0, "tid": 7, "ts": 1.0e6 + ts, "dur": d,
            "args": {"device": 0, "stream": 7}} for n, ts, d in events]
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11,
             "tid": 11, "ts": 1.0e6, "dur": 300.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 11, "tid": 11, "ts": 1.0e6 + 1, "dur": 3.0},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
             "pid": 0, "tid": 7, "ts": 1.0e6, "dur": 400.0},
            {"ph": "s", "cat": "ac2g", "name": "flow", "id": 1, "pid": 11,
             "tid": 11, "ts": 1.0e6}]
    return {"schemaVersion": 1, "traceEvents": host + dev}


def write(path, obj):
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            json.dump(obj, fh)
    else:
        with open(path, "w") as fh:
            json.dump(obj, fh)
    return path


def counters(trace):
    return ({k: pytest.approx(v) for k, v in trace.per_op_us.items()},
            dict(trace.calls))


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_parse_trace_files_equal_per_op_and_calls(tmp_path, suffix):
    jtrace = jattr.parse_trace_files(
        [write(tmp_path / ("jax.trace" + suffix), jax_layout(EVENTS))])
    trace = attr.parse_trace_files(
        [write(tmp_path / ("port.pt.trace" + suffix), torch_layout(EVENTS))])
    want_us, want_calls = counters(jtrace)
    assert dict(trace.per_op_us) == want_us
    assert dict(trace.calls) == want_calls
    assert trace.n_files == jtrace.n_files == 1
    assert trace.busy_us == sum(d for _, _, d in EVENTS)
    assert trace.window_us == pytest.approx(178.0)
    assert trace.wall_ms is None


def test_several_files_merge_as_the_jax_parser_merges(tmp_path):
    halves = (EVENTS[:3], EVENTS[3:])
    jfiles = [write(tmp_path / ("j%d.trace.json" % i), jax_layout(h, pid=i))
              for i, h in enumerate(halves)]
    files = [write(tmp_path / ("trace-%d-0.json" % i), torch_layout(h))
             for i, h in enumerate(halves)]
    files[1] = write(tmp_path / "trace-1-0.json.gz", torch_layout(halves[1]))
    jtrace, trace = jattr.parse_trace_files(jfiles), \
        attr.parse_trace_files(files)
    assert (dict(trace.per_op_us), dict(trace.calls)) == counters(jtrace)
    assert trace.n_files == jtrace.n_files == 2
    # both files start at the same clock reading; the busy time is their
    # busy times summed, as the JAX trace sums its module time
    assert trace.busy_us == pytest.approx(sum(d for _, _, d in EVENTS))
    one = [attr.parse_trace_files([f]) for f in files]
    assert trace.window_us == pytest.approx(sum(t.window_us for t in one))


def test_parse_trace_dir_finds_the_profilers_files(tmp_path):
    assert attr.parse_trace_dir(str(tmp_path)) is None
    assert jattr.parse_trace_dir(str(tmp_path)) is None
    nested = tmp_path / "plugins" / "profile"
    nested.mkdir(parents=True)
    write(nested / "host.pt.trace.json.gz", torch_layout(EVENTS[:2]))
    write(tmp_path / "trace-123-0.json", torch_layout(EVENTS[2:]))
    write(tmp_path / "notes.json", torch_layout(EVENTS))  # not a trace
    trace = attr.parse_trace_dir(str(tmp_path))
    assert trace.n_files == 2
    assert sum(trace.calls.values()) == len(EVENTS)


def test_a_cpu_profiler_trace_holds_no_device_events(tmp_path):
    """profiler_trace's file on the CPU: host ops only (no card)."""
    with stat.profiler_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = attr.parse_trace_dir(str(tmp_path))
    assert trace is not None and trace.n_files == 1
    assert trace.kernels == [] and trace.busy_us == 0.0
    assert attr.dispatch_gap(trace) is None


# names the H100 printed in chip_smoke.py's profiles (torch.profiler), and
# the class each falls in
CARD_NAMES = [
    ("void (anonymous namespace)::lstm_bwd_cluster<float, 5, true>(float "
     "const*, float const*, float const*)", "recurrent"),
    ("void (anonymous namespace)::lstm_fwd_cluster<float, 3, true>(float "
     "const*, float const*, float const*)", "recurrent"),
    ("void (anonymous namespace)::lstm_fwd_grid<float>(float const*)",
     "recurrent"),
    ("void (anonymous namespace)::lstm_bwd_wtiles<float>(float const*)",
     "recurrent"),
    ("void (anonymous namespace)::gru_fwd_cluster<float, 3>(float const*)",
     "recurrent"),
    ("void (anonymous namespace)::gru_bwd_cluster<float, 5>(float const*)",
     "recurrent"),
    ("lstm_seq_fwd_kernel", "recurrent"), ("gru_seq_bwd_kernel", "recurrent"),
    ("void seqre::gemm_f32<(anonymous namespace)::ZEpilogue<float> >(float "
     "const*, float const*, int, int)", "dot"),
    ("void seqre::gemm_bf16<(anonymous namespace)::UrEpilogue<float> >()",
     "dot"),
    ("void (anonymous namespace)::conv_fwd_simt_f32<128>(float const*, "
     "float const*, float*, int, int, int)", "conv"),
    ("void (anonymous namespace)::conv_fwd_tc_bf16<64>()", "conv"),
    ("(anonymous namespace)::bwdw_simt_f32(float const*, float const*, "
     "float*, int, int, int, int, int, int)", "conv"),
    ("void (anonymous namespace)::conv_bwdw_reduce(float const*, float*)",
     "conv"),
    ("void (anonymous namespace)::i8_simt_f32<64>(float const*)", "dot"),
    ("void (anonymous namespace)::i8_splitk<4>(float const*)", "dot"),
    ("void (anonymous namespace)::i8_reduce(float const*, float*)", "dot"),
    ("Memcpy DtoH (Device -> Pageable)", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int, "
     "int, int, float const*, int, float*)", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x32_warpgroupsize1x1x1_execute_segment_k_off_kernel__"
     "5x_cudnn", "conv"),
    ("void cudnn::cnn::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>()",
     "conv"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
     "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "dot"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nt_align1>("
     "cutlass_80_simt_sgemm_256x128_8x4_nt_align1::Params)", "dot"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, "
     "float, false, float, float, float>()", "dot"),
    ("nvjet_tst_128x64_64x7_1x2_h_bz_TNN", "dot"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, "
     "4, 4, false, false>()", "dot"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<"
     "4096ul>)", "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor<float> > >()", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::"
     "TensorIteratorBase&)>()", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float> > > "
     ">()", "reduce"),
    ("void (anonymous namespace)::indexing_backward_kernel<float, 4>(long "
     "const*, long const*, float const*)", "scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>()",
     "scatter"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float, "
     "int>(float const*, int, int, int)", "pool"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<float, "
     "int>()", "pool_bwd"),
    ("void at::native::transpose_kernel<float>()", "transpose"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>"
     "()", "other"),
]


@pytest.mark.parametrize("name,tag", CARD_NAMES,
                         ids=[n[:48] for n, _ in CARD_NAMES])
def test_classify_card_kernel_names(name, tag):
    assert attr.classify(name) == tag


@pytest.mark.parametrize("jax_name,port_name", [
    ("convolution.4", "void (anonymous namespace)::conv_fwd_simt_f32<128>"),
    ("dot.2", "nvjet_tst_128x64_64x7_1x2_h_bz_TNN"),
    ("all-reduce.1", "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
    ("copy.9", "Memcpy DtoD (Device -> Device)"),
    ("transpose.3", "void at::native::transpose_kernel<float>()"),
    ("reduce.5", "void at::native::reduce_kernel<512, 1>()"),
    ("scatter.2", "void at::native::_scatter_gather_elementwise_kernel<>()"),
    ("reduce-window.1", "max_pool_forward_nhwc<float, int>"),
    ("select-and-scatter.1", "max_pool_backward_nhwc<float, int>"),
    ("mystery", "void some_unknown_kernel()")])
def test_classify_keeps_the_jax_tags(jax_name, port_name):
    assert attr.classify(port_name) == jattr.classify(jax_name)


# the same durations under names that class alike in both packages
PAIRS = [("convolution.1", "conv_fwd_simt_f32", 0.0, 40.0),
         ("dot.1", "cutlass_80_simt_sgemm_128x64", 50.0, 30.0),
         ("copy.1", "Memcpy HtoD (Pageable -> Device)", 100.0, 10.0),
         ("dot.1", "cutlass_80_simt_sgemm_128x64", 120.0, 30.0),
         ("reduce.1", "reduce_kernel<512>", 200.0, 5.0),
         ("all-reduce.1", "ncclDevKernel_AllReduce", 300.0, 15.0)]


def traces(pairs=PAIRS):
    per_op, calls = collections.Counter(), collections.Counter()
    events = []
    for jname, _, ts, dur in pairs:
        per_op[jname] += dur
        calls[jname] += 1
        events.append((ts, dur))
    busy = sum(dur for _, _, _, dur in pairs)
    jtrace = jattr.DeviceTrace(busy, per_op, calls, events)
    trace = attr.DeviceTrace([(pname, ts, ts + dur)
                              for _, pname, ts, dur in pairs])
    return jtrace, trace


def test_class_report_equals_jax_on_alike_classes():
    jtrace, trace = traces()
    want = jattr.class_report(jtrace, steps=2)
    got = attr.class_report(trace, steps=2)
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    np.testing.assert_allclose([(ms, pct) for _, ms, pct in got],
                               [(ms, pct) for _, ms, pct in want])
    assert sum(pct for _, _, pct in got) == pytest.approx(100.0)
    assert [r["class"] for r in attr.op_report(trace, 2)] == \
        [r["class"] for r in jattr.op_report(jtrace, 2)]


def test_report_text_layout_in_port_terms():
    jtrace, trace = traces()
    jtext = jattr.report_text(jtrace, 2, top=3, flops_per_step=1e9,
                              wall_ms_per_step=1.0)
    text = attr.report_text(trace, 2, top=3, flops_per_step=1e9,
                            wall_ms_per_step=1.0)
    lines, jlines = text.splitlines(), jtext.splitlines()
    assert lines[0] == jlines[0].replace("module total", "busy total")
    assert lines[0].startswith("busy total: 0.065 ms/step | op total: "
                               "0.065 ms/step  (2 steps, 1 trace file)")
    assert lines[1].startswith("achieved: 15.4 TFLOP/s = 1.6% of the "
                               "H100's bf16 peak")
    assert lines[2].startswith("dispatch gap: busy 0.065 / window 0.158 "
                               "ms/step (58.7% idle, 3 kernels/step) -> ")
    assert "device-bound" in lines[2]
    sections = [ln for ln in lines if ln.endswith(":")]
    assert sections == ["by class (ms/step):",
                        "top kernels (ms/step, calls/step):"]
    by_class = lines[lines.index("by class (ms/step):") + 1:][:5]
    assert by_class == jlines[jlines.index("by class (ms/step):") + 1:][:5]
    top = lines[lines.index("top kernels (ms/step, calls/step):") + 1:]
    assert len(top) == 3 and top[0].split()[:2] == ["0.030", "x1"]
    assert "cutlass_80_simt_sgemm_128x64" in top[0]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        attr.report_text(trace, 2, hlo_defs={})
    two = attr.DeviceTrace(trace.kernels, n_files=2)
    assert "(1 steps, 2 trace files)" in attr.report_text(two, 1)


def test_report_text_names_a_host_bound_region():
    pairs = [("fusion.%d" % i, "vectorized_elementwise_kernel", i * 20.0,
              2.0) for i in range(16)]
    _, trace = traces(pairs)
    text = attr.report_text(trace, steps=2)
    assert "-> host-bound: 8 kernels/step" in text
    assert "  elementwise     0.016  (100.0%)" in text


class _Bundle:
    """A step bundle (``.step``, ``.carry``, ``.fetch``) over a number."""

    def __init__(self, step, carry, fetch):
        self.step, self.carry, self.fetch = step, carry, fetch


def test_device_busy_ms_is_none_on_the_cpu_in_both_packages():
    import jax
    import jax.numpy as jnp

    jbundle = _Bundle(jax.jit(lambda c: c + 1.0), jnp.zeros(()),
                      lambda c: c.block_until_ready())
    assert jattr.device_busy_ms(jbundle, steps=3) is None
    assert float(jbundle.carry) == 3.0  # the final carry written back
    bundle = _Bundle(lambda c: c + 1.0, torch.zeros(()), lambda c: c.item())
    assert attr.device_busy_ms(bundle, steps=3) is None
    assert attr.profile_bundle(bundle, steps=3) is None
    assert float(bundle.carry) == 1.0  # the untimed step ran, traced none


def test_device_events_read_the_raw_results():
    """capture's reader: the profiler's raw results, the card's events
    only (a CPU-only profile holds none), timed from the trace start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) + 1
    assert attr._device_events(torch, prof) == []
    ns = types.SimpleNamespace
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, start, end, annotation=False):
        return ns(name=lambda: name, device_type=lambda: device,
                  start_ns=lambda: start, end_ns=lambda: end,
                  is_user_annotation=lambda: annotation)

    results = ns(trace_start_ns=lambda: 10_000, events=lambda: [
        event("k", cuda, 11_000, 13_500),
        event("note", cuda, 10_000, 19_000, annotation=True),
        event("[memory]", cuda, 12_000, 12_000),
        event("aten::add", cpu, 10_000, 12_000)])
    fake = ns(profiler=ns(kineto_results=results))
    assert attr._device_events(torch, fake) == [("k", 1.0, 3.5)]


def test_parse_and_device_busy_signatures_are_jax():
    import inspect

    for name in ("parse_trace_files", "parse_trace_dir", "device_busy_ms",
                 "profile_bundle", "classify", "class_report",
                 "report_text"):
        assert inspect.signature(getattr(attr, name)) == \
            inspect.signature(getattr(jattr, name)), name
    for name in ("load_hlo_defs", "fusion_groups", "conv_detail"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            getattr(attr, name)("x")
    assert os.path.basename(attr.__file__) == "attribution.py"
