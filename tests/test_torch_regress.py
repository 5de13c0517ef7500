"""The port's bench regression gate (``paddle_tpu_torch/observe/regress.py``)
and ``cli observe --regress`` against the JAX package's
(``paddle_tpu/observe/regress.py``, ``benchmark/harness.py``
``sanitize_bench_row``, ``paddle_tpu/cli.py`` ``cmd_observe``), on the same
rows and baselines: directions, the audited record shapes, the best audited
row, the spread widening on both sides, the sanitiser's demotions and
refusals, the gate's results and strings, the CLI's exit codes and
``--json``, and the port's refusal of a default baseline (the repository's
audited rows were measured on another device).

``BENCH_r05.json`` is read as an input file to both gates only.
"""

import json
import os

import pytest

from benchmark.harness import sanitize_bench_row as jax_sanitize
from paddle_tpu import cli as jcli
from paddle_tpu.observe import regress as jregress
from paddle_tpu.observe import steplog as jsteplog

from paddle_tpu_torch import cli
from paddle_tpu_torch.observe import regress
from paddle_tpu_torch.observe import steplog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_R05 = os.path.join(REPO, "BENCH_r05.json")

UNITS = ["ms/batch", "ms/step", "ms", "s", "pct_waste", "bytes", "burn_rate",
         "convergence_steps", "skew", "samples/s", "qps", "MB/s",
         "checks_passed", "checks", "replicas", "widgets", None]
METRICS = ["x_train_samples_per_sec_bs64", "serve_qps", "serve_qps_p99",
           "x_train_ms_per_batch_bs1", "latency_ms", "mystery", ""]


def both(fn):
    """fn(module) through the JAX gate and the port's: (JAX, port)."""
    return fn(jregress), fn(regress)


@pytest.mark.parametrize("unit", UNITS)
def test_direction_for_every_unit(unit):
    row = {"unit": unit, "metric": "mystery"}
    want, got = both(lambda m: m.direction(row))
    assert got == want


@pytest.mark.parametrize("metric", METRICS)
def test_direction_from_the_metric_name(metric):
    want, got = both(lambda m: m.direction({"metric": metric}))
    assert got == want


def _write(tmp_path, name, obj):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


RECORD_SHAPES = {
    "driver_record": {"n": 1, "rc": 0, "tail": "\n".join([
        "warmup noise",
        json.dumps({"metric": "a_ms_per_batch", "value": 5.0,
                    "unit": "ms/batch"}),
        '{"metric": "truncated", "val',
        json.dumps({"metric": "b_samples_per_sec", "value": 900.0,
                    "unit": "samples/s"})]),
        "parsed": {"metric": "a_ms_per_batch", "value": 4.0,
                   "unit": "ms/batch"}},
    "bare_row": {"metric": "a_ms_per_batch", "value": 6.0,
                 "unit": "ms/batch"},
    "row_list": [{"metric": "a_ms_per_batch", "value": 7.0,
                  "unit": "ms/batch"},
                 {"metric": "c_qps", "value": 50.0, "unit": "qps"},
                 {"metric": "no_value", "value": "n/a", "unit": "ms"},
                 {"metric": "no_direction", "value": 1.0}],
    "baseline_published": {"metric": "a description, not a row",
                           "published": {"a_ms_per_batch": 3.5,
                                         "d_ms": {"value": 2.0,
                                                  "unit": "ms"},
                                         "skipped": "text"}},
}


@pytest.mark.parametrize("shape", sorted(RECORD_SHAPES))
def test_rows_from_each_record_shape(shape, tmp_path):
    obj = RECORD_SHAPES[shape]
    want, got = both(lambda m: list(m._rows_from_obj(obj, "src.json")))
    assert got == want and got
    path = _write(tmp_path, shape + ".json", obj)
    want, got = both(lambda m: m.best_audited([path]))
    assert got == want


def test_best_audited_over_all_shapes_and_r05(tmp_path):
    paths = [_write(tmp_path, name + ".json", obj)
             for name, obj in sorted(RECORD_SHAPES.items())]
    paths += [BENCH_R05, str(tmp_path / "missing.json"),
              _write(tmp_path, "broken.json", {"tail": 3})]
    (tmp_path / "bad.json").write_text("{not json")
    paths.append(str(tmp_path / "bad.json"))
    want, got = both(lambda m: m.best_audited(paths))
    assert got == want
    assert got["a_ms_per_batch"]["value"] == 3.5
    assert list(regress.iter_audited_rows(paths)) == \
        list(jregress.iter_audited_rows(paths))


def test_default_audit_paths_for_an_explicit_root(tmp_path):
    for name in ("BENCH_r02.json", "BENCH_r01.json", "BASELINE.json",
                 "OTHER.json"):
        (tmp_path / name).write_text("{}")
    want, got = both(lambda m: m.default_audit_paths(str(tmp_path)))
    assert got == want == [str(tmp_path / n) for n in
                           ("BENCH_r01.json", "BENCH_r02.json",
                            "BASELINE.json")]
    assert regress.default_audit_paths(REPO) == \
        jregress.default_audit_paths(REPO)


@pytest.fixture(scope="module")
def r05_best():
    want, got = both(lambda m: m.best_audited([BENCH_R05]))
    assert got == want
    return got


@pytest.mark.parametrize("spread,worse", [
    (None, 0.95), (None, 1.05), (None, 1.2), (2.0, 1.11), (2.0, 1.13),
    (15.0, 1.24), (15.0, 1.26), (0.0, 1.0999), (-5.0, 1.2)],
    ids=lambda v: str(v))
def test_check_row_on_both_sides_of_the_spread_widening(r05_best, spread,
                                                        worse):
    metric = "alexnet_train_ms_per_batch_bs128"
    row = {"metric": metric, "unit": "ms/batch",
           "value": r05_best[metric]["value"] * worse}
    if spread is not None:
        row["spread_pct"] = spread
    want, got = both(lambda m: m.check_row(row, r05_best))
    assert got == want
    want, got = both(lambda m: m.check_row(row, r05_best,
                                           base_tol_pct=25.0))
    assert got == want


def test_check_row_statuses_and_demoted_spread(r05_best):
    metric = "alexnet_train_ms_per_batch_bs128"
    best = r05_best[metric]["value"]
    rows = [{"metric": metric, "unit": "ms/batch", "value": best * 1.9,
             "spread_pct": 250.0},
            {"metric": metric, "unit": "ms/batch", "value": best * 2.2,
             "spread_pct": 250.0},
            {"metric": metric, "unit": "ms/batch", "value": "n/a"},
            {"metric": "unseen_ms_per_batch", "unit": "ms/batch",
             "value": 1.0},
            {"metric": "mystery", "unit": "widgets", "value": 1.0},
            {"metric": metric, "unit": "ms/batch", "value": best,
             "spread_raw_pct": 400.0, "spread_pct": None}]
    for row in rows:
        for sanitize in (True, False):
            want, got = both(lambda m: m.check_row(row, r05_best,
                                                   sanitize=sanitize))
            assert got == want
    zero = {metric: dict(r05_best[metric], value=0)}
    want, got = both(lambda m: m.check_row(rows[0], zero))
    assert got == want and got["status"] == "ungated"


SANITIZE_ROWS = [
    {"metric": "a", "value": 1.0, "wall_ms": 0.5, "device_ms": 0.9,
     "wall_vs_baseline": 2.0, "median": 0.5, "spread_pct": 5.0},
    {"metric": "b", "value": 1.0, "spread_pct": 15689.0},
    {"metric": "c", "value": 1.0, "wall_ms": 0.039, "device_ms": 0.587,
     "spread_pct": 150.0},
    {"metric": "d", "value": 1.0, "wall_ms": 2.0, "device_ms": 1.0,
     "spread_pct": 100.0},
    {"metric": "e", "value": 30.0, "unit": "qps", "p50_ms": 1.0,
     "p99_ms": 3.0}]
REFUSED_ROWS = [
    {"metric": "p99_below_p50", "value": 1.0, "p50_ms": 5.0, "p99_ms": 4.0},
    {"metric": "zero_qps", "value": 0.0, "unit": "qps"},
    {"metric": "negative_qps_key", "value": 1.0, "qps": -2.0}]


@pytest.mark.parametrize("row", SANITIZE_ROWS, ids=lambda r: r["metric"])
def test_sanitiser_demotes_as_the_harness_does(row):
    assert regress.sanitize_bench_row(dict(row)) == jax_sanitize(dict(row))


@pytest.mark.parametrize("row", REFUSED_ROWS, ids=lambda r: r["metric"])
def test_sanitiser_refuses_as_the_harness_does(row):
    with pytest.raises(ValueError) as want:
        jax_sanitize(dict(row))
    with pytest.raises(ValueError) as got:
        regress.sanitize_bench_row(dict(row))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        regress.check_row(row, {})


def test_gate_rows_and_format_result_equal(r05_best):
    metrics = sorted(r05_best)[:6]
    rows = []
    for i, metric in enumerate(metrics):
        base = r05_best[metric]
        dirn = regress.direction(base)
        factor = (1.0 + 0.08 * i) if dirn < 0 else (1.0 - 0.08 * i)
        rows.append({"metric": metric, "unit": base.get("unit"),
                     "value": base["value"] * factor,
                     "spread_pct": float(i)})
    rows += [{"metric": "unseen_ms", "value": 1.0},
             {"metric": "m", "value": None}]
    want, got = both(lambda m: m.gate_rows(rows, baseline_paths=[BENCH_R05],
                                           base_tol_pct=12.0))
    assert got == want
    assert got[1] and len(got[0]) == len(rows)
    assert [regress.format_result(r) for r in got[0]] == \
        [jregress.format_result(r) for r in want[0]]
    want, got = both(lambda m: m.gate_rows(rows, repo_root=REPO))
    assert got == want


def test_gate_rows_without_baselines_is_refused():
    rows = [{"metric": "a_ms", "value": 1.0}]
    with pytest.raises(ValueError, match="another device"):
        regress.gate_rows(rows)
    with pytest.raises(ValueError, match="another device"):
        regress.default_audit_paths()
    assert regress.GATE_ENV == "PADDLE_TPU_TORCH_BENCH_GATE"


@pytest.mark.parametrize("value,want_hard", [("hard", True), (" HARD ", True),
                                             ("warn", False), ("", False)])
def test_hard_gate_reads_the_ports_variable(monkeypatch, value, want_hard):
    monkeypatch.setenv("PADDLE_TPU_TORCH_BENCH_GATE", value)
    monkeypatch.setenv("PADDLE_TPU_BENCH_GATE", value)
    assert regress.hard_gate() is jregress.hard_gate() is want_hard


# -- cli observe --regress ---------------------------------------------------

def _telemetry(directory, log_mod, rows):
    with log_mod.StepLog(str(directory), run_name="bench",
                         compile_events=False) as slog:
        for row in rows:
            slog.write(dict(row, type="bench_row"))
        slog.write({"type": "step", "step": 0, "wall_ms": 1.0})


@pytest.mark.parametrize("value,rc", [(9.2, 0), (50.0, 1)])
def test_cli_observe_regress_through_both_clis(tmp_path, capsys, value, rc):
    rows = [{"metric": "alexnet_train_ms_per_batch_bs128", "value": value,
             "unit": "ms/batch", "spread_pct": 2.0},
            {"metric": "googlenet_train_ms_per_batch_bs128", "value": 20.0,
             "unit": "ms/batch", "spread_pct": 2.0}]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _telemetry(jdir, jsteplog, rows)
    _telemetry(pdir, steplog, rows)
    outs = {}
    for name, mod, d in (("jax", jcli, jdir), ("port", cli, pdir)):
        argv = ["observe", str(d), "--regress", BENCH_R05,
                "--regress-tol", "10"]
        assert mod.main(argv) == rc
        text = capsys.readouterr().out
        outs[name] = [ln for ln in text.splitlines()
                      if "row(s) checked" in ln or ln.startswith("    ")
                      and ("REGRESSION" in ln or ln.strip().startswith("ok"))]
        assert mod.main(argv + ["--json"]) == rc
        outs[name + "_json"] = json.loads(capsys.readouterr().out)["regress"]
    assert outs["port"] == outs["jax"] and outs["port"]
    assert outs["port_json"] == outs["jax_json"]
    assert ("1 gated" if rc else "0 gated") in outs["port"][0]


def test_cli_observe_without_regress_has_no_gate(tmp_path, capsys):
    _telemetry(tmp_path, steplog, [{"metric": "a_ms", "value": 1.0}])
    assert cli.main(["observe", str(tmp_path), "--json"]) == 0
    assert "regress" not in json.loads(capsys.readouterr().out)
