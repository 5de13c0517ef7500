"""The port's serving path on the CPU: export -> load -> engine against the
port's ``infer``; a JAX-written bundle's params.npz served by the port
against the JAX bundle; ``POST /infer``; the CLI. Every engine and server
is stopped inside its test (the suite-wide thread-leak gate)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import cli
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import (InferenceEngine, export_bundle,
                                    load_bundle, serve_in_thread)
from paddle_tpu_torch.serve.bundle import pad_rows
from paddle_tpu_torch.topology import Topology

BUILDER = "paddle_tpu_torch.models.text:text_classification_lstm"
SMALL = dict(dict_size=50, emb_size=16, hidden=32, num_classes=2,
             num_layers=2)
SEQ_LEN = 8


@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    """(bundle dir, output layer, Parameters) of the small flagship."""
    reset_name_counters()
    out = text_classification_lstm(**SMALL)
    params = Parameters.create(Topology(out), seed=5, device="cpu")
    # nonzero biases and peepholes, so the merged 7H bias is exercised
    rng = np.random.RandomState(5)
    for name in params.names():
        if name.endswith("wbias"):
            params.set(name, rng.randn(*params.get(name).shape) * 0.3)
    out_dir = str(tmp_path_factory.mktemp("bundle"))
    export_bundle(out, params, out_dir, batch_sizes=(1, 4), seq_len=SEQ_LEN)
    return out_dir, out, params


def _request(rng, rows):
    return {"word": rng.randint(0, 60, (rows, SEQ_LEN)).astype(np.int32),
            "word:lens": rng.randint(0, SEQ_LEN + 1, rows).astype(np.int32)}


def _as_batch(req):
    return [(list(ids[:n]),) for ids, n in zip(req["word"], req["word:lens"])]


def test_engine_matches_port_infer(port_bundle):
    out_dir, out, params = port_bundle
    bundle = load_bundle(out_dir, device="cpu")
    assert "builder" not in bundle.manifest
    assert [b["artifact"] for b in bundle.manifest["buckets"]] == [
        "fwd_b1.pt2", "fwd_b4.pt2"]
    rng = np.random.RandomState(0)
    engine = InferenceEngine(bundle, max_latency_ms=20.0)
    try:
        reqs = [_request(rng, n) for n in (1, 3, 2, 4, 1, 2, 3)]
        futures = [engine.submit(r) for r in reqs]
        for req, fut in zip(reqs, futures):
            got = fut.result(timeout=60)["lstm_out"]
            want = infer(out, params, _as_batch(req), device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    finally:
        engine.stop()
    stats = engine.stats()
    assert stats["requests"] == 7 and stats["rows"] == 16
    assert stats["warmup_batches"] == 2 and stats["batches_failed"] == 0
    assert stats["flush_on_size"] + stats["flush_on_deadline"] \
        + stats["flush_on_drain"] == stats["batches"]


def test_engine_flushes_on_size_and_on_deadline(port_bundle):
    bundle = load_bundle(port_bundle[0], device="cpu")
    rng = np.random.RandomState(1)
    engine = InferenceEngine(bundle, max_latency_ms=5000.0, warmup=False)
    try:
        # 4 rows fill the largest bucket at once: flush on size, long
        # before the 5 s deadline
        futures = [engine.submit(_request(rng, 2)) for _ in range(2)]
        for fut in futures:
            fut.result(timeout=30)
        assert engine.stats()["flush_on_size"] == 1
    finally:
        engine.stop()
    engine = InferenceEngine(bundle, max_latency_ms=1.0, warmup=False)
    try:
        engine.infer(_request(rng, 1), timeout=30)
        assert engine.stats()["flush_on_deadline"] == 1
    finally:
        engine.stop()


def test_jax_params_npz_serves_like_the_jax_bundle(tmp_path):
    """params.npz written by the JAX package's export_bundle loads into the
    port's bundle and answers as the JAX Bundle does."""
    import jax

    from paddle_tpu.graph import reset_name_counters as jax_reset_names
    from paddle_tpu.models.text import text_classification_lstm as jax_model
    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu.serve.bundle import Bundle as JaxBundle
    from paddle_tpu.serve.export import export_bundle as jax_export
    from paddle_tpu.topology import Topology as JaxTopology

    jax_reset_names()
    jout = jax_model(**SMALL)
    jtopo = JaxTopology(jout)
    jparams = JaxParameters()
    jparams._specs = jtopo.param_specs()
    jparams._values = jtopo.init_params(jax.random.PRNGKey(11))
    jax_dir = str(tmp_path / "jax")
    jax_export(jout, jparams, jax_dir, batch_sizes=(1, 4), seq_len=SEQ_LEN)

    port_dir = str(tmp_path / "port")
    reset_name_counters()
    export_bundle(text_classification_lstm(**SMALL),
                  Parameters.from_npz(str(tmp_path / "jax" / "params.npz")),
                  port_dir, batch_sizes=(1, 4), seq_len=SEQ_LEN)
    port = load_bundle(port_dir, device="cpu")
    ref = JaxBundle(jax_dir)
    assert port.manifest["inputs"] == ref.manifest["inputs"]
    assert port.batch_sizes() == ref.batch_sizes()
    rng = np.random.RandomState(2)
    for rows in (1, 3, 4):
        req = _request(rng, rows)
        np.testing.assert_allclose(port.infer(req)["lstm_out"],
                                   ref.infer(req)["lstm_out"], rtol=1e-5,
                                   atol=1e-5)


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as fh:
            return fh.status, json.loads(fh.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_infer_healthz_readyz(port_bundle):
    bundle = load_bundle(port_bundle[0], device="cpu")
    engine = InferenceEngine(bundle, max_latency_ms=2.0)
    server, thread = serve_in_thread(bundle, engine)
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        req = _request(np.random.RandomState(3), 2)
        code, body = _post(url + "/infer", {"inputs": {
            k: v.tolist() for k, v in req.items()}})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["outputs"]["lstm_out"]),
                                   bundle.infer(req)["lstm_out"], atol=1e-6)
        code, body = _post(url + "/infer", {"inputs": {"nope": [1]}})
        assert code == 400 and "unknown input" in body["error"]
        for path in ("/healthz", "/readyz"):
            with urllib.request.urlopen(url + path) as fh:
                assert fh.status == 200
                assert json.loads(fh.read())["ready"] is True
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.stop()
    assert not thread.is_alive()


def test_cli_export_and_selfcheck(tmp_path, capsys):
    out_dir = str(tmp_path / "b")
    assert cli.main(["export", "--builder", BUILDER, "--builder-kwargs",
                     json.dumps(SMALL), "--seed", "3", "--device", "cpu",
                     "-o", out_dir,
                     "--batch-sizes", "1,2", "--seq-len", "5"]) == 0
    exported = json.loads(capsys.readouterr().out)
    assert exported["buckets"] == [1, 2]
    assert exported["outputs"] == [{"name": "lstm_out", "dtype": "float32",
                                    "shape_suffix": [2]}]
    assert cli.main(["serve", out_dir, "--selfcheck", "--device", "cpu"]) == 0
    check = json.loads(capsys.readouterr().out)
    assert check["ok"] and check["outputs"] == {"lstm_out": [1, 2]}
    assert check["stats"]["warmup_batches"] == 2


def test_export_records_output_specs_without_running_the_model(
        port_bundle, tmp_path, monkeypatch):
    """Output specs come from the traced program's outputs (JAX's come
    from ``out_avals``): [size] per row after pooling, [seq_len, size]
    for a sequence output. Tracing runs no kernel and no plain version."""
    from paddle_tpu_torch import data_type, layer, networks
    from paddle_tpu_torch.ops import lstm_kernels

    with open(port_bundle[0] + "/manifest.json") as fh:
        assert json.load(fh)["outputs"] == [
            {"name": "lstm_out", "dtype": "float32", "shape_suffix": [2]}]
    reset_name_counters()
    words = layer.data(name="w", type=data_type.integer_value_sequence(9))
    emb = layer.embedding(input=words, size=4, name="e")
    lstm = networks.simple_lstm(input=emb, size=6, name="l")

    def refuse(*args):
        raise AssertionError("the export ran the model")

    monkeypatch.setattr(lstm_kernels, "lstm_seq_fwd_reference", refuse)
    manifest = export_bundle(
        lstm, Parameters.create(Topology(lstm), seed=1, device="cpu"),
        str(tmp_path), batch_sizes=(2,), seq_len=7)
    assert manifest["outputs"] == [
        {"name": lstm.name, "dtype": "float32", "shape_suffix": [7, 6]}]


@pytest.mark.parametrize("change,match", [
    ("drop", "missing"), ("extra", "unexpected"), ("reshape", "shape")])
def test_export_refuses_parameters_that_do_not_fit(port_bundle, tmp_path,
                                                   change, match):
    from paddle_tpu_torch.utils.error import EnforceError

    values = port_bundle[2].as_dict()
    name = sorted(values)[0]
    if change == "drop":
        del values[name]
    elif change == "extra":
        values["stray.w0"] = values[name]
    else:
        values[name] = values[name][:1]
    reset_name_counters()
    out = text_classification_lstm(**SMALL)
    if change == "extra":
        # names the topology does not declare ride along, as a trainer's
        # whole set does in the JAX package (a CRF's transitions): the
        # "unexpected" parameter is carried, not refused
        export_bundle(out, Parameters(values), str(tmp_path),
                      batch_sizes=(1,), seq_len=SEQ_LEN)
        with np.load(str(tmp_path / "params.npz")) as pz:
            assert "stray.w0" in pz.files
        return
    with pytest.raises(EnforceError, match=match):
        export_bundle(out, Parameters(values), str(tmp_path),
                      batch_sizes=(1,), seq_len=SEQ_LEN)


def test_bundle_refuses_bad_lengths_and_oversized_batches(port_bundle):
    bundle = load_bundle(port_bundle[0], device="cpu")
    req = _request(np.random.RandomState(4), 1)
    req["word:lens"][:] = SEQ_LEN + 1
    with pytest.raises(ValueError, match="lengths must be in"):
        bundle.infer(req)
    with pytest.raises(ValueError, match="largest exported bucket"):
        bundle.bucket_for(5)
    assert bundle.bucket_for(3)["batch"] == 4


def test_pad_rows_replicates_the_last_row():
    arr = np.arange(6).reshape(2, 3)
    padded = pad_rows(arr, 4)
    assert padded.shape == (4, 3)
    np.testing.assert_array_equal(padded[2:], [[3, 4, 5], [3, 4, 5]])
    with pytest.raises(ValueError):
        pad_rows(arr, 1)


def _jax_twin(tmp_path, params):
    """The JAX package's bundle of the small flagship with ``params``'
    values."""
    from paddle_tpu.graph import reset_name_counters as jax_reset_names
    from paddle_tpu.models.text import text_classification_lstm as jax_model
    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu.serve import load_bundle as jax_load
    from paddle_tpu.serve.export import export_bundle as jax_export
    from paddle_tpu.topology import Topology as JaxTopology

    jax_reset_names()
    jout = jax_model(**SMALL)
    jparams = JaxParameters()
    jparams._specs = JaxTopology(jout).param_specs()
    jparams._values = {k: params.get(k) for k in params.names()}
    jax_export(jout, jparams, str(tmp_path / "jax"), batch_sizes=(1, 4),
               seq_len=SEQ_LEN)
    return jax_load(str(tmp_path / "jax"))


def test_engine_metrics_stats_and_shedding_match_jax(port_bundle, tmp_path):
    """The engine's metric families (names and labels), its stats() keys
    and its queue-bound shedding are the JAX engine's, on the same
    requests; the answers agree within 1e-5."""
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import InferenceEngine as JaxEngine
    from paddle_tpu.serve import Overloaded as JaxOverloaded

    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import Overloaded

    out_dir, _, params = port_bundle
    ref = _jax_twin(tmp_path, params)
    bundle = load_bundle(out_dir, device="cpu")
    rng = np.random.RandomState(12)
    reqs = [_request(rng, n) for n in (1, 3, 2)]
    runs = {}
    for name, make, reg, shed in (
            ("port", lambda r: InferenceEngine(
                bundle, max_latency_ms=1.0, metrics_registry=r,
                model="m", replica=0, max_queue_rows=4), MetricsRegistry(),
             Overloaded),
            ("jax", lambda r: JaxEngine(
                ref, max_latency_ms=1.0, metrics_registry=r, model="m",
                replica=0, max_queue_rows=4), JaxRegistry(),
             JaxOverloaded)):
        engine = make(reg)
        try:
            answers = [engine.infer(r)["lstm_out"] for r in reqs]
            # a 4-row request fills the bound until its batch flushes;
            # the 1-row one behind it is shed
            with engine._cv:
                engine.submit(_request(rng, 4))
                with pytest.raises(shed, match="max_queue_rows=4"):
                    engine.submit(_request(rng, 1))
            stats = engine.stats()
        finally:
            engine.stop()
        runs[name] = (answers, reg.snapshot(), stats)
    (got, snap, stats), (want, jsnap, jstats) = runs["port"], runs["jax"]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for kind in ("counters", "gauges", "histograms"):
        # build_info names each package's framework version
        assert sorted(k for k in snap[kind] if "build_info" not in k) == \
            sorted(k for k in jsnap[kind] if "build_info" not in k), kind
    for key in ('paddle_tpu_serve_requests_total{model="m",replica="0"}',
                'paddle_tpu_serve_rows_total{model="m",replica="0"}'):
        assert snap["counters"][key] == jsnap["counters"][key]
    assert snap["counters"][
        'paddle_tpu_serve_shed_total{model="m",reason="queue_full",'
        'replica="0"}'] >= 1
    assert set(jstats) <= set(stats)
    assert stats["shed"] >= 1 and stats["model"] == "m"


def test_http_routes_answer_as_the_jax_server(port_bundle):
    """/livez, /metrics, /stats, /debug/traces, /debug/slo,
    /debug/compiles and /manifest answer; /debug/control is 404 without
    a controller; traceparent is echoed."""
    bundle = load_bundle(port_bundle[0], device="cpu")
    engine = InferenceEngine(bundle, max_latency_ms=2.0)
    server, thread = serve_in_thread(bundle, engine)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        req = _request(np.random.RandomState(13), 2)
        parent = "00-%s-%s-01" % ("ab" * 16, "cd" * 8)
        http_req = urllib.request.Request(
            url + "/infer",
            data=json.dumps({"inputs": {k: v.tolist()
                                        for k, v in req.items()}}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": parent})
        with urllib.request.urlopen(http_req) as fh:
            assert fh.headers["traceparent"].split("-")[1] == "ab" * 16
        for path in ("/livez", "/stats", "/debug/traces", "/debug/slo",
                     "/debug/compiles", "/manifest"):
            with urllib.request.urlopen(url + path) as fh:
                body = json.loads(fh.read())
                assert fh.status == 200, path
            if path == "/debug/compiles":
                # the two buckets' programs, loaded at warmup
                assert body == {"compiles": 2}
            if path == "/manifest":
                assert body == bundle.manifest
            if path == "/debug/slo":
                assert body["state"] == "no_objective"
        with urllib.request.urlopen(url + "/metrics") as fh:
            text = fh.read().decode()
        assert "paddle_tpu_serve_requests_total" in text
        assert "paddle_tpu_serve_request_latency_ms" in text
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url + "/debug/control")
        assert exc.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.stop()
