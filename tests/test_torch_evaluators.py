"""The port's evaluators against the JAX package's, on the CPU.

Every ported evaluator is built over data layers in both packages, fed the
same two batches made from a numpy seed, its batch statistics merged on
the host, and its result compared: within 1e-6 (float32 statistics summed
in a different order; counts are exact). The printers' statistics are
compared instead of their (None) results. ``detection_map`` waits for the
detection layers and raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.topology import Topology

TOL = 1e-6
B, T, C = 6, 7, 5


def _seq_lengths(rng):
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    return lens


def _inputs(rng):
    """numpy inputs every case picks from."""
    lens = _seq_lengths(rng)
    return {
        "logits": rng.randn(B, C).astype(np.float32),
        "probs": rng.dirichlet(np.ones(2), B).astype(np.float32),
        "label": rng.randint(0, C, B).astype(np.int32),
        "binary": rng.randint(0, 2, B).astype(np.int32),
        "weight": rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32),
        "query": rng.randint(0, 2, B).astype(np.int32),
        "score": rng.randn(B, 1).astype(np.float32),
        "seq_scores": [rng.randn(n, C).astype(np.float32) for n in lens],
        "seq_label": [rng.randint(0, C, n).astype(np.int32) for n in lens],
        "seq_tags": [rng.randint(0, C, n).astype(np.int32) for n in lens],
        "ctc_label": [rng.randint(1, C, rng.randint(1, 4)).astype(np.int32)
                      for _ in lens],
    }


def _feed(pkg, slots, data):
    """``{slot: (input key, kind)}`` -> the package's feed."""
    feed = {}
    for slot, (key, kind) in slots.items():
        value = data[key]
        if kind == "seq":
            if pkg is jpaddle:
                feed[slot] = JaxSeq.from_sequences(value, max_len=8)
            else:
                feed[slot] = SequenceBatch.from_sequences(value, max_len=8,
                                                          device="cpu")
        else:
            feed[slot] = (jnp.asarray(value) if pkg is jpaddle
                          else torch.from_numpy(value))
    return feed


def _types(pkg):
    dt = pkg.data_type
    return {"logits": dt.dense_vector(C), "probs": dt.dense_vector(2),
            "label": dt.integer_value(C), "binary": dt.integer_value(2),
            "weight": dt.dense_vector(1), "query": dt.integer_value(4),
            "score": dt.dense_vector(1),
            "seq_scores": dt.dense_vector_sequence(C),
            "seq_label": dt.integer_value_sequence(C),
            "seq_tags": dt.integer_value_sequence(C),
            "ctc_label": dt.integer_value_sequence(C)}


# name -> (builder(ev, inputs) -> node, {slot: (input key, kind)})
CASES = {
    "classification_error": (
        lambda ev, i: ev.classification_error(input=i["x"], label=i["y"]),
        {"x": ("logits", "dense"), "y": ("label", "dense")}),
    "classification_error_top3": (
        lambda ev, i: ev.classification_error(input=i["x"], label=i["y"],
                                              top_k=3),
        {"x": ("logits", "dense"), "y": ("label", "dense")}),
    "classification_error_weighted": (
        lambda ev, i: ev.classification_error(input=i["x"], label=i["y"],
                                              weight=i["w"]),
        {"x": ("logits", "dense"), "y": ("label", "dense"),
         "w": ("weight", "dense")}),
    "classification_error_seq": (
        lambda ev, i: ev.classification_error(input=i["x"], label=i["y"]),
        {"x": ("seq_scores", "seq"), "y": ("seq_label", "seq")}),
    "seq_classification_error": (
        lambda ev, i: ev.seq_classification_error(input=i["x"],
                                                  label=i["y"]),
        {"x": ("seq_scores", "seq"), "y": ("seq_label", "seq")}),
    "sum": (
        lambda ev, i: ev.sum_evaluator(input=i["x"]),
        {"x": ("logits", "dense")}),
    "sum_weighted": (
        lambda ev, i: ev.sum_evaluator(input=i["x"], weight=i["w"]),
        {"x": ("logits", "dense"), "w": ("weight", "dense")}),
    "column_sum": (
        lambda ev, i: ev.column_sum_evaluator(input=i["x"]),
        {"x": ("logits", "dense")}),
    "auc": (
        lambda ev, i: ev.auc(input=i["x"], label=i["y"], weight=i["w"],
                             num_thresholds=64),
        {"x": ("probs", "dense"), "y": ("binary", "dense"),
         "w": ("weight", "dense")}),
    "precision_recall": (
        lambda ev, i: ev.precision_recall(input=i["x"], label=i["y"]),
        {"x": ("logits", "dense"), "y": ("label", "dense")}),
    "precision_recall_positive": (
        lambda ev, i: ev.precision_recall(input=i["x"], label=i["y"],
                                          weight=i["w"], positive_label=2),
        {"x": ("logits", "dense"), "y": ("label", "dense"),
         "w": ("weight", "dense")}),
    "chunk_IOB": (
        lambda ev, i: ev.chunk(input=i["x"], label=i["y"],
                               chunk_scheme="IOB", num_chunk_types=2),
        {"x": ("seq_tags", "seq"), "y": ("seq_label", "seq")}),
    "chunk_IOE_scores": (
        lambda ev, i: ev.chunk(input=i["x"], label=i["y"],
                               chunk_scheme="IOE", num_chunk_types=2),
        {"x": ("seq_scores", "seq"), "y": ("seq_label", "seq")}),
    "chunk_IOBES": (
        lambda ev, i: ev.chunk(input=i["x"], label=i["y"],
                               chunk_scheme="IOBES", num_chunk_types=1),
        {"x": ("seq_tags", "seq"), "y": ("seq_label", "seq")}),
    "chunk_plain_excluded": (
        lambda ev, i: ev.chunk(input=i["x"], label=i["y"],
                               chunk_scheme="plain", num_chunk_types=4,
                               excluded_chunk_types=[1]),
        {"x": ("seq_tags", "seq"), "y": ("seq_label", "seq")}),
    "ctc_error": (
        lambda ev, i: ev.ctc_error(input=i["x"], label=i["y"]),
        {"x": ("seq_scores", "seq"), "y": ("ctc_label", "seq")}),
    "pnpair": (
        lambda ev, i: ev.pnpair(input=i["x"], label=i["y"], query_id=i["q"],
                                weight=i["w"]),
        {"x": ("score", "dense"), "y": ("label", "dense"),
         "q": ("query", "dense"), "w": ("weight", "dense")}),
}

PRINTERS = {
    "gradient_printer": (lambda ev, i: ev.gradient_printer(input=i["x"]),
                         {"x": ("logits", "dense")}),
    "maxid_printer": (lambda ev, i: ev.maxid_printer(input=i["x"],
                                                     num_results=3),
                      {"x": ("logits", "dense")}),
    "maxframe_printer": (lambda ev, i: ev.maxframe_printer(input=i["x"],
                                                           num_frames=2),
                         {"x": ("seq_scores", "seq")}),
    "seqtext_printer": (lambda ev, i: ev.seqtext_printer(input=i["x"]),
                        {"x": ("seq_scores", "seq")}),
    "classification_error_printer": (
        lambda ev, i: ev.classification_error_printer(input=i["x"],
                                                      label=i["y"]),
        {"x": ("logits", "dense"), "y": ("label", "dense")}),
}


def _build(pkg, case):
    build, slots = case
    if pkg is jpaddle:
        jax_reset_names()
    else:
        reset_name_counters()
    types = _types(pkg)
    inputs = {slot: pkg.layer.data(name=slot, type=types[key])
              for slot, (key, _) in slots.items()}
    return build(pkg.evaluator, inputs), slots


def _stats(pkg, node, feed):
    if pkg is jpaddle:
        vals, _ = JaxTopology(node).apply({}, feed, mode="test")
        return jax.tree_util.tree_map(np.asarray, vals[node.name])
    out, _ = Topology(node).apply({}, feed, mode="test")
    return paddle.evaluator.host_stats(out[node.name])


def _results(pkg, case):
    node, slots = _build(pkg, case)
    rng = np.random.RandomState(7)
    acc, stats = None, []
    for _ in range(2):
        s = _stats(pkg, node, _feed(pkg, slots, _inputs(rng)))
        stats.append(s)
        acc = node.merge(acc, s)
    return node.result(acc), stats


def _close(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], "%s/%s" % (what, k))
    elif isinstance(want, (list, tuple)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=what)
    else:
        assert got == pytest.approx(want, rel=TOL, abs=TOL), what


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluator_matches_jax(name):
    want, _ = _results(jpaddle, CASES[name])
    got, _ = _results(paddle, CASES[name])
    _close(got, want, name)


@pytest.mark.parametrize("name", sorted(PRINTERS))
def test_printer_statistics_match_jax(name, caplog):
    want_result, want = _results(jpaddle, PRINTERS[name])
    got_result, got = _results(paddle, PRINTERS[name])
    assert got_result is None and want_result is None
    for g, w in zip(got, want):
        _close(g, {k: np.asarray(v).tolist() for k, v in w.items()}, name)


def test_value_printer_passes_its_input_through(capsys):
    reset_name_counters()
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(3))
    node = paddle.evaluator.value_printer(input=x)
    value = torch.arange(6.0).reshape(2, 3)
    out, _ = Topology(node).apply({}, {"x": value}, mode="test")
    assert torch.equal(out[node.name], value)
    assert "x:" in capsys.readouterr().out


def test_detection_map_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        paddle.evaluator.detection_map(input=None, label=None)


def test_evaluator_aliases_match_jax():
    names = [n for n in dir(jpaddle.evaluator) if n.endswith("_evaluator")]
    assert names and all(hasattr(paddle.evaluator, n) for n in names)


def test_trainer_reports_metrics_as_jax_does():
    """SGD(extra_layers=[classification_error]) fills EndIteration.metrics,
    EndPass.metrics and TestResult.metrics as the JAX trainer does."""
    def run(pkg, jax_side):
        (jax_reset_names if jax_side else reset_name_counters)()
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4))
        y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(3))
        out = pkg.layer.fc(input=x, size=3, act=pkg.activation.Softmax(),
                           name="o")
        cost = pkg.layer.classification_cost(input=out, label=y)
        err = pkg.evaluator.classification_error(input=out, label=y)
        rng = np.random.RandomState(0)
        init = {"o.w0": (rng.randn(4, 3) * 0.5).astype(np.float32),
                "o.wbias": np.zeros(3, np.float32)}
        samples = [(rng.randn(4).astype(np.float32), int(rng.randint(0, 3)))
                   for _ in range(16)]
        if jax_side:
            params = jpaddle.parameters.Parameters.create(cost)
            for k, v in init.items():
                params.set(k, v)
            tr = pkg.trainer.SGD(cost, params, pkg.optimizer.Momentum(
                learning_rate=0.5), extra_layers=[err])
        else:
            params = paddle.parameters.Parameters(
                {k: torch.from_numpy(v) for k, v in init.items()},
                Topology(cost).param_specs())
            tr = pkg.trainer.SGD(cost, params, pkg.optimizer.Momentum(
                learning_rate=0.5), extra_layers=[err], device="cpu")
        events = []
        tr.train(pkg.batch(lambda: iter(samples), 4), num_passes=2,
                 event_handler=events.append,
                 test_reader=pkg.batch(lambda: iter(samples[:8]), 4))
        return [(type(e).__name__, getattr(e, "cost", None),
                 dict(getattr(e, "metrics", {}) or {})) for e in events]

    want, got = run(jpaddle, True), run(paddle, False)
    assert [w[0] for w in want] == [g[0] for g in got]
    for (kind, wc, wm), (_, gc, gm) in zip(want, got):
        if wc is not None:
            assert gc == pytest.approx(wc, rel=1e-5, abs=1e-5), kind
        _close(gm, wm, kind)
    assert any(m for _, _, m in got)
