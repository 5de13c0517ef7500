"""The continuous-batching decode path of the port against the JAX package,
on the CPU: the ``decode`` manifest block, the streamability refusals,
``Bundle.decode_step`` (fp and int8), and ``ContinuousScheduler``.

Sizes are tests/test_scheduler.py's (tagger hidden 12, 2 slots, window 4,
seq_len 32); both packages export the same numpy parameters
(tests/torch_decode.py). The JAX side runs as its own tests run it (its
exported step on the CPU).

- Decode step: three windows with resets, an idle slot and length-1 rows;
  outputs and carries within 1e-5 of JAX's ``Bundle.decode_step`` for the
  GRU tagger and an LSTM per-position head (two carry leaves). float32
  sums in another order; these inputs show about 1e-7.
- int8: the payload is bit-identical to JAX's and the step's outputs are
  within 1e-5.
- Scheduler: continuous equals the port's and JAX's per-request answers
  (1e-5), a reused slot leaks nothing, the JAX scheduler's answers on the
  same sequences agree within 1e-5, ``serve_decode`` / ``serve_request``
  records are valid against tests/golden/steplog_schema.json, the step's
  shapes never change after warmup and no kernel library builds or loads.
Every scheduler is stopped inside its test.
"""

import os

import numpy as np
import pytest

import torch

from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import ContinuousScheduler, Overloaded
from paddle_tpu_torch.serve import export as port_export
from tests.torch_decode import (GRU_BUILDER, MODELS, OUTPUT, SMALL,
                                as_numpy, export_pair, jax_model,
                                jax_parameters, load_pair, numpy_params,
                                per_request, port_parameters, port_topology,
                                read_records, schema_valid, sequences)

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gru_pair(tmp_path_factory):
    return load_pair(tmp_path_factory.mktemp("gru_pair"), "gru")


def _sched(bundle, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ContinuousScheduler(bundle, **kw)


# -- export ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gru", "lstm"])
def test_decode_manifest_block_matches_jax(tmp_path, model):
    builder, kwargs = MODELS[model]
    manifest, port_dir, jmanifest, _ = export_pair(
        tmp_path, builder, kwargs, slots=(2, 4), window=8)
    dec, jdec = manifest["decode"], jmanifest["decode"]
    assert sorted(dec) == sorted(jdec) == ["carry", "slots", "window"]
    assert dec["window"] == jdec["window"] == 8
    # one decode-step program per slot capacity, as JAX's one artifact
    assert dec["slots"] == [{"slots": b["slots"],
                             "artifact": "step_s%d.pt2" % b["slots"]}
                            for b in jdec["slots"]]
    assert [b["artifact"] for b in jdec["slots"]] == [
        "step_s%d.jaxexp" % b["slots"] for b in jdec["slots"]]
    assert dec["carry"] == jdec["carry"]
    leaves = 2 if model == "lstm" else 1
    assert [len(v) for v in dec["carry"].values()] == [leaves]


def test_decode_bundle_accessors(gru_pair):
    port, ref = gru_pair
    assert port.has_decoder() and port.decode_window == ref.decode_window
    assert port.decode_slot_sizes() == ref.decode_slot_sizes() == [2]
    carry = port.zero_carry(2)
    jcarry = ref.zero_carry(2)
    assert {k: [t.shape for t in v] for k, v in carry.items()} == {
        k: [tuple(a.shape) for a in v] for k, v in jcarry.items()}
    with pytest.raises(ValueError, match="slot capacity"):
        port.zero_carry(3)
    flat, jflat = port.dummy_decode_flat(), ref.dummy_decode_flat()
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == {
        k: (v.shape, v.dtype) for k, v in jflat.items()}


def _port_node_types():
    """The layer types the port's nodes carry: the registered constructor
    names, and the type strings its layer modules pass to ``make_node``
    (``context_projection_layer`` builds a ``context_projection`` node)."""
    import ast
    import glob

    from paddle_tpu_torch.layer.base import layer_registry

    types = set(layer_registry.names())
    for path in glob.glob(os.path.join(ROOT, "paddle_tpu_torch", "layer",
                                       "*.py")):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "make_node" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                types.add(node.args[0].value)
    return types


def test_stream_blocked_set_is_the_jax_set_on_port_layers():
    from paddle_tpu.analyze.topology_check import packed_rejecting_node_types

    jax_set = packed_rejecting_node_types()
    assert "context_projection" in _port_node_types()
    assert port_export.STREAM_BLOCKED_TYPES == (
        jax_set & _port_node_types())


def _refusal(tmp_path, builder, kwargs, seq_len=8):
    """(port message, JAX message) of one decode export refusal."""
    with pytest.raises(Exception) as port_exc:
        export_pair(tmp_path, builder, kwargs, seq_len=seq_len)
    from paddle_tpu.serve.export import export_bundle as jax_export

    jout = jax_model(builder, **kwargs)
    arrays = numpy_params(port_topology(builder, **kwargs).param_specs())
    with pytest.raises(Exception) as jax_exc:
        jax_export(jout, jax_parameters(jout, arrays),
                   str(tmp_path / "jax_again"), batch_sizes=(1,),
                   seq_len=seq_len, decode_slots=(2,))
    return str(port_exc.value), str(jax_exc.value)


@pytest.mark.parametrize("case,builder,kwargs,match", [
    ("pooling", "paddle_tpu_torch.models.text:text_classification_lstm",
     dict(dict_size=20, emb_size=4, hidden=8, num_layers=2),
     "is not streamable: layer"),
    ("reverse", "tests.torch_decode:reverse_gru_tagger", SMALL,
     "cannot stream: a right-to-left scan"),
    ("non_sequence", "paddle_tpu_torch.models.vision:mlp",
     dict(hidden=(8,)), "every input to be a sequence slot"),
    ("carry_free", "tests.torch_decode:embedding_tagger", SMALL,
     "found no recurrent carries"),
    ("context_window", "tests.torch_decode:context_tagger", SMALL,
     "is not streamable: layer"),
])
def test_decode_export_refusals_match_jax(tmp_path, case, builder, kwargs,
                                          match):
    port_msg, jax_msg = _refusal(tmp_path, builder, kwargs)
    assert match in port_msg and match in jax_msg, (port_msg, jax_msg)
    # the JAX message is the port's first line (the port adds the layer
    # stack of a refusal raised inside the forward as a note)
    assert port_msg.splitlines()[0] in jax_msg


# -- the step ----------------------------------------------------------------

WINDOWS = (  # (lens, reset) per window over 2 slots
    ([4, 1], [1.0, 1.0]),   # both admitted; slot 1 a length-1 row
    ([0, 3], [0.0, 0.0]),   # slot 0 idle, slot 1 continues
    ([2, 4], [1.0, 0.0]),   # slot 0 re-admitted: its carry zeroed first
)


def _three_windows(port, ref, vocab):
    rng = np.random.RandomState(5)
    carry, jcarry = port.zero_carry(), ref.zero_carry()
    for lens, reset in WINDOWS:
        flat = port.dummy_decode_flat()
        flat["word"][:] = rng.randint(0, vocab, flat["word"].shape)
        flat["lens"][:] = lens
        flat["reset"][:] = reset
        carry, outs = port.decode_step(carry, flat)
        jcarry, jouts = ref.decode_step(jcarry, dict(flat), 2)
        for name, val in outs.items():
            assert val.shape == tuple(np.shape(jouts[name]))
            np.testing.assert_allclose(val.numpy(), np.asarray(jouts[name]),
                                       rtol=TOL, atol=TOL)
        got, want = as_numpy(carry), as_numpy(jcarry)
        assert sorted(got) == sorted(want)
        for layer in got:
            for a, b in zip(got[layer], want[layer]):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    return carry


@pytest.mark.parametrize("model", ["gru", "lstm"])
def test_decode_step_matches_jax(tmp_path, model):
    port, ref = load_pair(tmp_path, model)
    carry = _three_windows(port, ref, SMALL["dict_size"])
    assert len(next(iter(carry.values()))) == (2 if model == "lstm" else 1)


def test_decode_step_idle_slot_keeps_its_carry_and_is_functional(gru_pair):
    port, _ = gru_pair
    rng = np.random.RandomState(9)
    carry = {k: [torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
                 for t in v] for k, v in port.zero_carry().items()}
    before = {k: [t.clone() for t in v] for k, v in carry.items()}
    flat = port.dummy_decode_flat()
    flat["lens"][:] = [0, 3]
    new, _ = port.decode_step(carry, flat)
    for layer, leaves in new.items():
        # the idle slot's carry passes through bit for bit; the caller's
        # carry is never written
        assert torch.equal(leaves[0][0], before[layer][0][0])
        assert torch.equal(carry[layer][0], before[layer][0])
        assert not torch.equal(leaves[0][1], before[layer][0][1])


def test_int8_decode_payload_and_step_match_jax(tmp_path):
    manifest, port_dir, jmanifest, jax_dir = export_pair(
        tmp_path, GRU_BUILDER, SMALL, quantize="int8")
    assert manifest["quantization"] == jmanifest["quantization"]
    with np.load(port_dir + "/params.npz") as a, \
            np.load(jax_dir + "/params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name
    from paddle_tpu.serve import load_bundle as jax_load
    from paddle_tpu_torch.serve import load_bundle

    port = load_bundle(port_dir, device="cpu")
    assert port.params()["gru_tag_out.w0"].dtype == torch.int8
    _three_windows(port, jax_load(jax_dir), SMALL["dict_size"])


def test_carry_slice_and_insert_round_trip(gru_pair):
    port, ref = gru_pair
    rng = np.random.RandomState(2)
    carry = {k: [torch.from_numpy(rng.randn(*t.shape).astype(np.float32))
                 for t in v] for k, v in port.zero_carry().items()}
    rows = port.carry_slice(carry, 1)
    jrows = ref.carry_slice({k: [t.numpy() for t in v]
                             for k, v in carry.items()}, 1)
    for layer in rows:
        np.testing.assert_array_equal(rows[layer][0].numpy(),
                                      np.asarray(jrows[layer][0]))
    host = {k: [t.numpy() for t in v] for k, v in rows.items()}
    moved = port.carry_insert(carry, host, 0)
    for layer, leaves in moved.items():
        assert torch.equal(leaves[0][0], carry[layer][0][1])
        assert torch.equal(leaves[0][1], carry[layer][0][1])
        assert not torch.equal(carry[layer][0][0], carry[layer][0][1])


# -- the scheduler -------------------------------------------------------------

def test_continuous_decode_equals_per_request(gru_pair):
    port, ref = gru_pair
    lengths = [7, 3, 10, 1, 5, 9, 2]
    seqs = sequences(lengths, seed=3)
    with _sched(port) as sched:
        results = [f.result(timeout=120)
                   for f in [sched.submit({"word": s}) for s in seqs]]
        stats = sched.stats()
    for seq, got in zip(seqs, results):
        got = got["gru_tag_out"]
        want = per_request(port, seq, "gru_tag_out")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, per_request(ref, seq, "gru_tag_out"),
                                   rtol=TOL, atol=TOL)
    assert stats["requests"] == stats["admitted"] == stats["retired"] == 7
    assert stats["admitted"] > stats["slots"]
    assert stats["slot_steps"] == sum(lengths)


def test_continuous_decode_matches_the_jax_scheduler(gru_pair):
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import ContinuousScheduler as JaxScheduler

    port, ref = gru_pair
    seqs = sequences([5, 12, 1, 8, 3], seed=21)
    with _sched(port) as sched:
        got = [f.result(timeout=120)["gru_tag_out"]
               for f in [sched.submit({"word": s}) for s in seqs]]
        stats = sched.stats()
    with JaxScheduler(ref, metrics_registry=JaxRegistry()) as jsched:
        want = [f.result(timeout=120)["gru_tag_out"]
                for f in [jsched.submit({"word": s}) for s in seqs]]
        jstats = jsched.stats()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for key in ("requests", "admitted", "retired", "slot_steps", "slots",
                "window"):
        assert stats[key] == jstats[key], key


def test_slot_reuse_does_not_leak_state(gru_pair):
    port, _ = gru_pair
    long_seq = sequences([25], seed=11)[0]
    shorts = sequences([2, 3, 2, 4, 3], seed=12)
    with _sched(port) as sched:
        f_long = sched.submit({"word": long_seq})
        f_shorts = [sched.submit({"word": s}) for s in shorts]
        got_long = f_long.result(timeout=120)["gru_tag_out"]
        got_shorts = [f.result(timeout=120)["gru_tag_out"]
                      for f in f_shorts]
    np.testing.assert_allclose(got_long,
                               per_request(port, long_seq, "gru_tag_out"),
                               rtol=TOL, atol=TOL)
    for s, got in zip(shorts, got_shorts):
        np.testing.assert_allclose(got, per_request(port, s, "gru_tag_out"),
                                   rtol=TOL, atol=TOL)


def test_lstm_continuous_decode_equals_per_request(tmp_path):
    port, ref = load_pair(tmp_path, "lstm")
    seqs = sequences([6, 1, 9, 4], seed=13)
    with _sched(port) as sched:
        got = [f.result(timeout=120)[OUTPUT["lstm"]]
               for f in [sched.submit({"word": s}) for s in seqs]]
    for seq, out in zip(seqs, got):
        np.testing.assert_allclose(out, per_request(ref, seq,
                                                    OUTPUT["lstm"]),
                                   rtol=TOL, atol=TOL)


def test_scheduler_smoke_admit_retire_reuse(gru_pair):
    port, _ = gru_pair
    with _sched(port) as sched:
        assert sched.live() and sched.ready()
        f1 = sched.submit({"word": np.array([1, 2, 3], np.int32)})
        f2 = sched.submit({"word": np.array([[4, 5]], np.int32)})
        padded = np.zeros((1, 6), np.int32)
        padded[0, :4] = [6, 7, 8, 9]
        f3 = sched.submit({"word": padded,
                           "word:lens": np.array([4], np.int32)})
        shapes = [f.result(timeout=120)["gru_tag_out"].shape
                  for f in (f1, f2, f3)]
        assert shapes == [(3, 5), (2, 5), (4, 5)]
        stats = sched.stats()
        assert stats["retired"] == 3 and stats["in_flight"] == 0
        with pytest.raises(ValueError, match="ONE sequence"):
            sched.submit({"word": np.zeros((2, 3), np.int32)})
        with pytest.raises(KeyError, match="missing sequence input"):
            sched.submit({"wrong": np.array([1], np.int32)})
        with pytest.raises(ValueError, match="empty"):
            sched.submit({"word": np.zeros((0,), np.int32)})
    assert not sched.live()
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit({"word": np.array([1], np.int32)})


def test_one_step_shape_and_no_kernel_build_after_warmup(gru_pair,
                                                         monkeypatch):
    """The port's analog of JAX's one jit entry: after the warmup the step
    sees one set of shapes, however slots churn, and no kernel library
    builds or loads (ops/_build.py reports each as an event)."""
    from paddle_tpu_torch.observe import steplog

    port, _ = gru_pair
    with _sched(port) as sched:
        events, shapes = [], set()
        monkeypatch.setattr(steplog, "emit_event",
                            lambda name, secs: events.append(name))
        step = port.decode_step

        def recording(carry, flat, slots=None):
            shapes.add(tuple(sorted((k, np.shape(v))
                                    for k, v in flat.items())))
            return step(carry, flat, slots)

        monkeypatch.setattr(port, "decode_step", recording)
        for f in [sched.submit({"word": s})
                  for s in sequences([3, 11, 1, 6, 2, 7], seed=8)]:
            f.result(timeout=120)
        monkeypatch.undo()
    assert len(shapes) == 1 and not events


def test_scheduler_refusals(gru_pair, tmp_path):
    port, _ = gru_pair
    with _sched(port, max_queue=0) as sched:
        with pytest.raises(Overloaded, match="max_queue=0") as exc:
            sched.submit({"word": np.array([1], np.int32)})
        assert exc.value.reason == "queue_full"
        assert sched.stats()["shed"] == 1
        # a traced request is shed like any other, and the live knobs
        # register with the JAX scheduler's names
        from paddle_tpu.control import KnobRegistry as JaxKnobs
        from paddle_tpu.serve import ContinuousScheduler as JaxScheduler
        from paddle_tpu_torch.control import KnobRegistry
        from paddle_tpu_torch.observe.tracing import TraceContext

        with pytest.raises(Overloaded, match="max_queue=0"):
            sched.submit({"word": np.array([1], np.int32)},
                         trace=TraceContext.mint())
        knobs = KnobRegistry()
        sched.register_knobs(knobs)
        jknobs = JaxKnobs()
        JaxScheduler.register_knobs(sched, jknobs)
        assert knobs.names() == jknobs.names() == [
            "sched.admit_budget", "sched.max_queue", "sched.park_budget"]
        assert knobs.snapshot() == jknobs.snapshot()
    from paddle_tpu_torch.serve import export_bundle, load_bundle

    topo = port_topology(GRU_BUILDER, **SMALL)
    export_bundle(topo.outputs,
                  port_parameters(topo, numpy_params(topo.param_specs())),
                  str(tmp_path / "plain"), batch_sizes=(1,), seq_len=8)
    with pytest.raises(ValueError, match="decode_slots= for continuous"):
        ContinuousScheduler(load_bundle(str(tmp_path / "plain"),
                                        device="cpu"))


def test_metric_families_match_the_jax_scheduler(gru_pair):
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import ContinuousScheduler as JaxScheduler

    port, ref = gru_pair
    reg, jreg = MetricsRegistry(), JaxRegistry()
    seq = sequences([5], seed=1)[0]
    with _sched(port, metrics_registry=reg, model="tagger") as sched:
        sched.infer({"word": seq})
    with JaxScheduler(ref, metrics_registry=jreg, model="tagger") as jsched:
        jsched.infer({"word": seq})

    def serve_series(text):
        return {line.split(" ")[0] for line in text.splitlines()
                if line.startswith("paddle_tpu_serve_")
                and not line.startswith("#")
                and "_bucket{" not in line}

    got, want = serve_series(reg.to_prometheus()), serve_series(
        jreg.to_prometheus())
    assert got == want
    assert 'paddle_tpu_serve_decode_iterations_total{model="tagger"}' in got


def test_serve_decode_and_request_records_are_schema_valid(gru_pair,
                                                           tmp_path):
    from paddle_tpu_torch.observe.steplog import StepLog

    port, _ = gru_pair
    log = StepLog(str(tmp_path), run_name="serve")
    with _sched(port, steplog=log, model="tagger") as sched:
        for f in [sched.submit({"word": s})
                  for s in sequences([6, 2, 9], seed=4)]:
            f.result(timeout=120)
    log.close()
    recs = read_records(log.path)
    decode = [r for r in recs if r["type"] == "serve_decode"]
    request = [r for r in recs if r["type"] == "serve_request"]
    assert decode and len(request) == 3
    assert sum(r["steps"] for r in decode) == 17
    assert all(r["slots"] == 2 and r["window"] == 4
               and r["model"] == "tagger" for r in decode)
    schema_valid(recs)
