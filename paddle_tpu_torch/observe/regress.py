"""Spread-aware bench regression gate (paddle_tpu/observe/regress.py).

Compares a freshly measured bench row against the BEST audited value
per metric across a set of audited records, and flags a *gated
regression* when the fresh value is worse than the audited best by more
than a tolerance that the row's own measured variance widens:

    tolerance_pct = base_tol_pct + spread_pct(row)

A row whose own min-of-N spread is 15% cannot honestly be called 12%
slower: the spread is the row's error bar. :func:`sanitize_bench_row`
demotes spreads above 100% as noise; such rows gate with the capped 100%
widening, i.e. only catastrophic regressions. Every row passes through
``sanitize_bench_row`` first, so the gate inherits the audited-row field
invariants (no wall < device, no p99 < p50, no qps <= 0) as its first
line of defense.

Call surfaces:

* library — :func:`check_row` / :func:`gate_rows`;
* CLI — ``python -m paddle_tpu_torch.cli observe <dir> --regress
  <baseline.json>`` gates the ``bench_row`` records mirrored into a
  telemetry dir and exits non-zero on a gated regression.

The audited records of the repository root (``BENCH_*.json``,
``BASELINE.json``) hold another device's rows, so :func:`gate_rows` takes
its baselines only where the caller names them (``baseline_paths=``, or
``repo_root=`` for that root's audited set): it never gates the card's
rows against them by default.
"""

import glob
import json
import os

DEFAULT_BASE_TOL_PCT = 10.0
GATE_ENV = "PADDLE_TPU_TORCH_BENCH_GATE"

# units where a SMALLER value is better; everything rate-like is
# bigger-better. Metrics whose direction cannot be determined are not
# gated (status "ungated"). "bytes" gates footprint rows, "replicas"
# capacity rows (fewer fitting is a regression), "burn_rate" SLO rows
# (observe/health.py), "convergence_steps" the controller's rows
# (control/controller.py) and "skew" the training fleet's straggler rows
# (observe/trainview.py).
_LOWER_BETTER_UNITS = ("ms/batch", "ms/step", "ms", "s", "pct_waste",
                       "bytes", "burn_rate", "convergence_steps",
                       "skew")
_HIGHER_BETTER_UNITS = ("samples/s", "qps", "MB/s", "checks_passed",
                        "checks", "replicas")


def sanitize_bench_row(rec):
    """Audited-row invariants applied to a bench row (the JAX package's
    ``benchmark/harness.py`` ``sanitize_bench_row``): no row may carry
    ``wall_ms < device_ms`` or ``spread_pct > 100``.

    * a wall slope below the device time moves to ``wall_collapsed_ms``
      (with the wall-derived ``wall_vs_baseline`` / ``median`` dropped):
      the device time is the value;
    * a spread above 100% moves to ``spread_raw_pct`` and ``spread_pct``
      becomes None: min-of-N under that spread is noise, not a
      repeatability statement.

    Serving rows (throughput ``qps`` and ``p50_ms`` / ``p99_ms``) are
    refused, not demoted, on violation: percentiles of one sample set are
    monotone in the quantile and a throughput over a positive request
    count is positive, so ``p99 < p50`` or ``qps <= 0`` can only mean the
    measurement is broken (ValueError).

    Mutates and returns ``rec``.
    """
    p50, p99 = rec.get("p50_ms"), rec.get("p99_ms")
    if p50 is not None and p99 is not None and p99 < p50:
        raise ValueError(
            "refusing serving row %r: p99_ms %.4f < p50_ms %.4f — "
            "percentiles of one latency sample are monotone; the "
            "measurement is broken" % (rec.get("metric"), p99, p50))
    qps = rec.get("qps", rec.get("value") if rec.get("unit") == "qps"
                  else None)
    if qps is not None and qps <= 0:
        raise ValueError(
            "refusing serving row %r: qps %.4f <= 0 — throughput over a "
            "positive request count cannot be non-positive"
            % (rec.get("metric"), qps))
    notes = []
    wall, dev = rec.get("wall_ms"), rec.get("device_ms")
    if wall is not None and dev is not None and wall < dev:
        rec.pop("wall_ms")
        rec.pop("wall_vs_baseline", None)
        rec.pop("median", None)
        rec["wall_collapsed_ms"] = wall
        notes.append("wall slope %.3fms < device %.3fms: tunnel-collapsed "
                     "chain, device time is the value" % (wall, dev))
    spread = rec.get("spread_pct")
    if spread is not None and spread > 100.0:
        rec["spread_raw_pct"] = spread
        rec["spread_pct"] = None
        notes.append("wall spread >100%: tunnel noise, not repeatability")
    if notes:
        rec["sanity_note"] = "; ".join(notes)
    return rec


def direction(row):
    """+1 when a bigger value is better, -1 when smaller is better,
    None when unknown (row not gateable)."""
    unit = row.get("unit")
    if unit in _HIGHER_BETTER_UNITS:
        return 1
    if unit in _LOWER_BETTER_UNITS:
        return -1
    metric = row.get("metric") or ""
    if "samples_per_sec" in metric or metric.endswith("_qps") \
            or "_qps_" in metric:
        return 1
    if "ms_per_batch" in metric or metric.endswith("_ms"):
        return -1
    return None


def _rows_from_obj(obj, source):
    """Yield bench-row dicts out of one parsed JSON document: a driver
    record ``{"tail": "<json lines>", "parsed": {...}}``, a bare row, a
    list of rows, and a baseline's ``published`` map."""
    if isinstance(obj, list):
        for item in obj:
            yield from _rows_from_obj(item, source)
        return
    if not isinstance(obj, dict):
        return
    # container shapes take precedence: a baseline's top level has a
    # descriptive "metric" string next to its "published" map — a dict is
    # a bare row only when it carries none of the container keys
    is_container = (isinstance(obj.get("tail"), str)
                    or isinstance(obj.get("parsed"), dict)
                    or isinstance(obj.get("published"), dict))
    if "metric" in obj and not is_container:
        yield dict(obj, _source=source)
        return
    tail = obj.get("tail")
    if isinstance(tail, str):
        for line in tail.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a cut tail can truncate a line mid-write
            yield from _rows_from_obj(rec, source)
    parsed = obj.get("parsed")
    if isinstance(parsed, dict):
        yield from _rows_from_obj(parsed, source)
    published = obj.get("published")
    if isinstance(published, dict):
        for metric, value in published.items():
            if isinstance(value, (int, float)):
                yield {"metric": metric, "value": value, "_source": source}
            elif isinstance(value, dict) and "value" in value:
                yield dict(value, metric=metric, _source=source)


def iter_audited_rows(paths):
    for path in paths:
        try:
            with open(path) as fh:
                obj = json.load(fh)
        except (OSError, ValueError):
            continue
        yield from _rows_from_obj(obj, os.path.basename(path))


def default_audit_paths(repo_root=None):
    """The audited set of ``repo_root``: every ``BENCH_*.json`` plus
    ``BASELINE.json`` there. Refused without a root (module docstring)."""
    if repo_root is None:
        raise ValueError(
            "no default baseline: the repository's audited BENCH_*.json / "
            "BASELINE.json rows were measured on another device; pass "
            "baseline_paths= (cli observe --regress FILE) or repo_root=")
    paths = sorted(glob.glob(os.path.join(repo_root, "BENCH_*.json")))
    baseline = os.path.join(repo_root, "BASELINE.json")
    if os.path.exists(baseline):
        paths.append(baseline)
    return paths


def best_audited(paths):
    """{metric: row} — the best audited row per metric across ``paths``
    (direction-aware; rows without a numeric value or a known direction
    are skipped)."""
    best = {}
    for row in iter_audited_rows(paths):
        metric, value = row.get("metric"), row.get("value")
        if not metric or not isinstance(value, (int, float)):
            continue
        dirn = direction(row)
        if dirn is None:
            continue
        cur = best.get(metric)
        if cur is None or (value - cur["value"]) * dirn > 0:
            best[metric] = row
    return best


def _effective_spread(row):
    """The row's own spread widening, capped at 100% (sanitize demotes
    bigger spreads to ``spread_raw_pct``: a row that noisy can only be
    gated for catastrophic regressions)."""
    spread = row.get("spread_pct")
    if spread is None and "spread_raw_pct" in row:
        return 100.0
    try:
        return min(max(float(spread), 0.0), 100.0)
    except (TypeError, ValueError):
        return 0.0


def check_row(row, best, base_tol_pct=DEFAULT_BASE_TOL_PCT,
              sanitize=True):
    """Gate one fresh row against a :func:`best_audited` map.

    Returns a result dict:
    ``{"metric", "status", "value", "best", "best_source",
       "worse_pct", "tol_pct"}`` with status one of

    * ``regression`` — worse than the audited best by more than the
      widened tolerance (the gated case);
    * ``ok``         — within tolerance, equal, or better;
    * ``no_baseline``/``ungated``/``no_value`` — not comparable.

    ``sanitize=True`` (default) first applies :func:`sanitize_bench_row`
    to a copy (serving-row violations raise ValueError).
    """
    if sanitize:
        row = sanitize_bench_row(dict(row))
    metric = row.get("metric")
    result = {"metric": metric, "value": row.get("value"),
              "tol_pct": None, "worse_pct": None, "best": None,
              "best_source": None}
    value = row.get("value")
    if not isinstance(value, (int, float)):
        result["status"] = "no_value"
        return result
    dirn = direction(row)
    if dirn is None:
        result["status"] = "ungated"
        return result
    base = best.get(metric)
    if base is None:
        result["status"] = "no_baseline"
        return result
    best_value = float(base["value"])
    result["best"] = best_value
    result["best_source"] = base.get("_source")
    if best_value == 0:
        result["status"] = "ungated"
        return result
    # positive = worse, in percent of the audited best
    worse_pct = (best_value - value) / abs(best_value) * 100.0 * dirn
    tol_pct = float(base_tol_pct) + _effective_spread(row)
    result["worse_pct"] = round(worse_pct, 2)
    result["tol_pct"] = round(tol_pct, 2)
    result["status"] = "regression" if worse_pct > tol_pct else "ok"
    return result


def gate_rows(rows, baseline_paths=None, repo_root=None,
              base_tol_pct=DEFAULT_BASE_TOL_PCT):
    """Gate many rows; returns (results, regressions) where
    ``regressions`` is the gated subset. The baselines are
    ``baseline_paths``, or :func:`default_audit_paths` of ``repo_root``;
    with neither the call is refused (module docstring)."""
    if baseline_paths is None:
        baseline_paths = default_audit_paths(repo_root)
    best = best_audited(baseline_paths)
    results = [check_row(row, best, base_tol_pct=base_tol_pct)
               for row in rows]
    regressions = [r for r in results if r["status"] == "regression"]
    return results, regressions


def hard_gate():
    """True when ``PADDLE_TPU_TORCH_BENCH_GATE=hard``: a gated regression
    then fails the bench run instead of only warning."""
    return os.environ.get(GATE_ENV, "").strip().lower() == "hard"


def format_result(result):
    if result["status"] == "regression":
        return ("REGRESSION %s: %.4g is %.1f%% worse than audited best "
                "%.4g (%s), tolerance %.1f%%"
                % (result["metric"], result["value"], result["worse_pct"],
                   result["best"], result["best_source"],
                   result["tol_pct"]))
    if result["status"] == "ok" and result["best"] is not None:
        return ("ok %s: %.4g vs audited best %.4g (%s), %.1f%% "
                "%s within tolerance %.1f%%"
                % (result["metric"], result["value"], result["best"],
                   result["best_source"], abs(result["worse_pct"]),
                   "worse" if result["worse_pct"] > 0 else "better/equal",
                   result["tol_pct"]))
    return "%s %s" % (result["status"], result["metric"])
