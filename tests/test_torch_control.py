"""Feedback control of the port's serving tier, against the JAX package
(tests/test_control.py, ported): ``control/knobs.py`` and
``control/controller.py`` are the port's own copies of the JAX modules.

* ``Knob`` / ``KnobRegistry``: clamping, the integer grid, the apply hook
  before the record, duplicate names, the snapshot;
* ``Controller``: scripted verdict walks pinning hysteresis, cooldowns,
  bounded steps, the phase-to-knob plays, bound-pinned fall-through and
  the rollback guard, and the same walks through the JAX controller
  giving the same action tape;
* every move as a ``control_action`` record, a ``paddle_tpu_control_*``
  metric and ``cli observe``'s knob-move timeline;
* the engine's and the scheduler's ``register_knobs``, ``GET
  /debug/control``, and ``cli serve --autotune`` in a subprocess.

Left out: the linter fixtures (tests/test_torch_analyze.py holds the
port's), the bench gate (observe/regress.py: tests/test_torch_regress.py,
where ``convergence_steps`` gates lower-better as in the JAX package) and
the slo-ab bench (benchmark/exp_serve.py).
The router's knobs are held in tests/test_torch_router.py, the replica
and worker fleets' in tests/test_torch_fleet.py and
tests/test_torch_workers.py.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import control as jax_control

from paddle_tpu_torch.control import Controller, Knob, KnobRegistry
from paddle_tpu_torch.observe import steplog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- Knob / KnobRegistry -----------------------------------------------------

def test_knob_clamps_to_bounds_and_integer_grid():
    k = Knob("a.b", value=5.0, min=1.0, max=10.0, step=0.5)
    assert k.set(99.0) == (5.0, 10.0)
    assert k.set(-3.0) == (10.0, 1.0)
    assert k.value == 1.0
    ki = Knob("a.i", value=4, min=1, max=8, step=1, integer=True)
    assert ki.set(6.6) == (4.0, 7.0)  # rounds onto the integer grid
    # construction clamps too: registration is behavior-neutral even
    # when the owner's current value sits outside the declared range
    assert Knob("a.c", value=0.0, min=1.0, max=2.0).value == 1.0


def test_knob_apply_hook_runs_before_record_and_sees_clamped():
    seen = []
    k = Knob("a.b", value=5.0, min=1.0, max=10.0,
             apply=lambda v: seen.append(v))
    k.set(50.0)
    assert seen == [10.0]  # the hook got the CLAMPED value
    ki = Knob("a.i", value=2, min=1, max=8, integer=True,
              apply=lambda v: seen.append(v))
    ki.set(3.4)
    assert seen[-1] == 3 and isinstance(seen[-1], int)

    def boom(v):
        raise RuntimeError("owner rejected")

    kb = Knob("a.x", value=5.0, min=1.0, max=10.0, apply=boom)
    with pytest.raises(RuntimeError):
        kb.set(7.0)
    assert kb.value == 5.0  # a raising hook leaves the view consistent


def test_knob_validation_rejects_bad_ranges():
    with pytest.raises(ValueError, match="min"):
        Knob("a.b", value=1.0, min=5.0, max=1.0)
    with pytest.raises(ValueError, match="step"):
        Knob("a.b", value=1.0, min=0.0, max=2.0, step=0.0)


def test_registry_duplicates_unknowns_and_snapshot():
    reg = KnobRegistry()
    reg.register(Knob("a.b", value=5.0, min=1.0, max=10.0))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(Knob("a.b", value=2.0, min=0.0, max=4.0))
    with pytest.raises(KeyError):
        reg.set("a.missing", 1.0)
    assert reg.get("a.missing") is None
    reg.register(Knob("a.a", value=1.0, min=0.0, max=2.0))
    assert reg.names() == ["a.a", "a.b"]
    assert len(reg) == 2
    assert reg.set("a.b", 7.0) == (5.0, 7.0)
    snap = reg.snapshot()
    assert list(snap) == ["a.a", "a.b"]
    assert snap["a.b"] == {"value": 7.0, "min": 1.0, "max": 10.0,
                           "step": 1.0, "cost_hint": "cheap",
                           "integer": False}
    json.dumps(snap)  # the /debug/control body must serialize


# -- Controller: scripted verdict walks --------------------------------------

def _verdict(state="burning", phase="queue_ms", fast=2.0):
    return {"state": state, "breaching_phase": phase,
            "burn_rates": {"fast": fast}}


def _controller(knobs, **kw):
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("hysteresis", 2)
    return Controller(None, knobs, **kw)


def test_controller_hysteresis_needs_consecutive_breaches():
    reg = KnobRegistry()
    reg.register(Knob("sched.max_queue", value=96, min=48, max=960,
                      step=48, integer=True))
    ctl = _controller(reg, hysteresis=2)
    assert ctl.step(_verdict(), now=0.0) is None   # streak 1 < 2
    action = ctl.step(_verdict(), now=1.0)         # streak 2: move
    assert action["knob"] == "sched.max_queue"
    assert action["reason"] == "shed_earlier"
    assert action["new"] < action["old"]
    assert ctl.moves == 1
    # an ok verdict resets the streak: the next breach starts over
    assert ctl.step(_verdict(state="ok"), now=20.0) is None
    assert ctl.step(_verdict(), now=21.0) is None  # streak 1 again


def test_controller_cooldown_benches_a_moved_knob():
    reg = KnobRegistry()
    reg.register(Knob("sched.max_queue", value=960, min=48, max=960,
                      step=48, integer=True))
    ctl = _controller(reg, cooldown_s=10.0, hysteresis=1)
    assert ctl.step(_verdict(), now=0.0) is not None
    # breaching verdicts inside the cooldown: the only knob rests
    assert ctl.step(_verdict(), now=5.0) is None
    assert ctl.step(_verdict(), now=9.9) is None
    # past the cooldown it moves again
    assert ctl.step(_verdict(), now=10.1) is not None
    assert ctl.moves == 2


def test_controller_bounded_steps_and_severity():
    reg = KnobRegistry()
    reg.register(Knob("sched.max_queue", value=40, min=1, max=100,
                      step=1, integer=True))
    ctl = _controller(reg, hysteresis=1, rel_step=0.25,
                      max_step_mult=16)
    # burning: magnitude = max(step, 0.25*40) = 10
    a1 = ctl.step(_verdict(state="burning"), now=0.0)
    assert (a1["old"], a1["new"]) == (40.0, 30.0)
    # breached doubles the magnitude, capped at step * max_step_mult
    a2 = ctl.step(_verdict(state="breached"), now=20.0)
    assert a2["old"] == 30.0
    assert a2["new"] == pytest.approx(30.0 - min(0.25 * 30 * 2, 16.0))


def test_controller_play_order_and_bound_pinned_fallthrough():
    reg = KnobRegistry()
    reg.register(Knob("sched.max_queue", value=48, min=48, max=960,
                      step=48, integer=True))     # already at its floor
    reg.register(Knob("engine.batch_deadline_ms", value=60.0, min=0.25,
                      max=500.0, step=0.5))
    ctl = _controller(reg, hysteresis=1)
    # queue family: the pinned ceiling is skipped, the deadline (the
    # bare engine's only queue lever) takes the move
    action = ctl.step(_verdict(phase="queue_ms"), now=0.0)
    assert action["knob"] == "engine.batch_deadline_ms"
    assert action["reason"] == "tighten_deadline"
    assert action["new"] < 60.0
    assert reg.get("sched.max_queue").value == 48.0


def test_controller_spill_family_raises_idle_spill():
    reg = KnobRegistry()
    reg.register(Knob("sched.idle_spill_ms", value=100.0, min=1.0,
                      max=600000.0, step=25.0))
    ctl = _controller(reg, hysteresis=1)
    action = ctl.step(_verdict(phase="spill_restore_ms"), now=0.0)
    assert action["knob"] == "sched.idle_spill_ms"
    assert action["reason"] == "spill_later"
    assert action["new"] > 100.0


def test_controller_unknown_phase_or_no_registered_knob_is_a_noop():
    reg = KnobRegistry()
    reg.register(Knob("sched.idle_spill_ms", value=100.0, min=1.0,
                      max=600000.0))
    ctl = _controller(reg, hysteresis=1)
    assert ctl.step(_verdict(phase="serialize_ms"), now=0.0) is None
    assert ctl.step(_verdict(phase="decode_ms"), now=1.0) is None
    assert ctl.moves == 0


def test_controller_rollback_reverts_and_double_benches():
    reg = KnobRegistry()
    reg.register(Knob("engine.batch_deadline_ms", value=60.0, min=0.25,
                      max=500.0, step=0.5))
    ctl = _controller(reg, cooldown_s=10.0, hysteresis=1,
                      rollback_factor=1.1)
    a1 = ctl.step(_verdict(phase="queue_ms", fast=2.0), now=0.0)
    moved_to = a1["new"]
    assert moved_to < 60.0
    # the NEXT verdict is worse than 2.0 * 1.1 while still breaching:
    # the guard reverts the move even though the knob is on cooldown
    rb = ctl.step(_verdict(phase="queue_ms", fast=3.0), now=1.0)
    assert rb["reason"] == "rollback" and rb["rollback"] is True
    assert (rb["old"], rb["new"]) == (moved_to, 60.0)
    assert reg.get("engine.batch_deadline_ms").value == 60.0
    assert ctl.rollbacks == 1 and ctl.moves == 1
    # benched for DOUBLE the cooldown from the rollback
    assert ctl.step(_verdict(fast=2.0), now=15.0) is None
    assert ctl.step(_verdict(fast=2.0), now=22.0) is not None


def test_controller_not_worse_keeps_the_move():
    reg = KnobRegistry()
    reg.register(Knob("engine.batch_deadline_ms", value=60.0, min=0.25,
                      max=500.0, step=0.5))
    ctl = _controller(reg, hysteresis=1)
    ctl.step(_verdict(fast=2.0), now=0.0)
    # same burn (within the tolerance factor): no rollback, and an ok
    # verdict clears the pending judgement entirely
    assert ctl.step(_verdict(fast=2.05), now=1.0) is None
    assert ctl.step(_verdict(state="ok", fast=0.1), now=2.0) is None
    assert ctl.rollbacks == 0
    assert reg.get("engine.batch_deadline_ms").value < 60.0


def test_controller_snapshot_recent_and_named_thread():
    reg = KnobRegistry()
    reg.register(Knob("engine.batch_deadline_ms", value=60.0, min=0.25,
                      max=500.0, step=0.5))

    class _Monitor:
        def evaluate(self):
            return _verdict(state="ok")

    ctl = Controller(_Monitor(), reg, interval_s=0.05, hysteresis=1)
    ctl.step(_verdict(), now=0.0)
    snap = ctl.snapshot()
    assert snap["enabled"] is False and snap["moves"] == 1
    assert "engine.batch_deadline_ms" in snap["knobs"]
    assert snap["actions"] == ctl.recent()
    json.dumps(snap)
    ctl.start()
    try:
        names = [t.name for t in threading.enumerate()]
        assert "slo-controller" in names  # the PTA003 contract, live
        assert ctl.snapshot()["enabled"] is True
        ctl.start()  # idempotent: no second thread
        assert [t.name for t in threading.enumerate()
                ].count("slo-controller") == 1
    finally:
        ctl.stop()
    assert "slo-controller" not in [t.name for t in threading.enumerate()]
    assert ctl.snapshot()["enabled"] is False


# -- observability: steplog record, metrics, summarize, cli observe ----------

def test_control_actions_reach_steplog_metrics_and_summary(tmp_path):
    from paddle_tpu_torch.observe.metrics import MetricsRegistry

    reg = KnobRegistry()
    reg.register(Knob("engine.batch_deadline_ms", value=60.0, min=0.25,
                      max=500.0, step=0.5))
    metrics = MetricsRegistry()
    slog = steplog.StepLog(str(tmp_path), run_name="ctl")
    ctl = _controller(reg, hysteresis=1, slog=slog, registry=metrics,
                      model="mnist_mlp")
    ctl.step(_verdict(fast=2.0), now=0.0)                # move
    ctl.step(_verdict(fast=9.0), now=1.0)                # rollback
    slog.close()
    records = [r for r in steplog.read_jsonl(slog.path)
               if r.get("type") == "control_action"]
    assert len(records) == ctl.moves + ctl.rollbacks == 2
    move, rollback = records
    assert move["knob"] == "engine.batch_deadline_ms"
    assert move["reason"] == "tighten_deadline"
    assert move["breaching_phase"] == "queue_ms"
    assert move["model"] == "mnist_mlp"
    assert "rollback" not in move          # additive: absent, not false
    assert rollback["reason"] == "rollback"
    assert rollback["rollback"] is True
    assert rollback["new"] == move["old"] == 60.0
    # metric mirror: per-knob action counter, installed value, rollback
    snap = metrics.snapshot()
    label = 'knob="engine.batch_deadline_ms"'
    actions = {k: v for k, v in snap["counters"].items()
               if k.startswith("paddle_tpu_control_actions_total")}
    assert actions == {"paddle_tpu_control_actions_total{%s}" % label: 2}
    assert snap["counters"][
        "paddle_tpu_control_rollbacks_total{%s}" % label] == 1
    assert snap["gauges"][
        "paddle_tpu_control_knob{%s}" % label] == 60.0  # last install
    # summarize_dir folds the action tape into the run summary
    (run,) = steplog.summarize_dir(str(tmp_path))["runs"]
    assert run["control_rollbacks"] == 1
    got = [(a["knob"], a["reason"]) for a in run["control_actions"]]
    assert got == [("engine.batch_deadline_ms", "tighten_deadline"),
                   ("engine.batch_deadline_ms", "rollback")]


def test_cli_observe_prints_control_timeline(tmp_path, capsys):
    from paddle_tpu_torch import cli

    slog = steplog.StepLog(str(tmp_path), run_name="control")
    slog.log_control_action(knob="engine.batch_deadline_ms", old=60.0,
                            new=52.0, reason="tighten_deadline",
                            breaching_phase="queue_ms",
                            burn_rate_before=4.2)
    slog.log_control_action(knob="engine.batch_deadline_ms", old=52.0,
                            new=60.0, reason="rollback", rollback=True)
    slog.close()
    rc = cli.main(["observe", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "control timeline: 2 knob move(s), 1 rollback(s)" in out
    assert "engine.batch_deadline_ms" in out
    assert "tighten_deadline" in out and "[queue_ms]" in out
    assert "rollback" in out


def test_control_action_schema_is_additive():
    """The golden schema carries the new record type with its required
    core (old steplog readers skip unknown types; new readers rely on
    these fields existing)."""
    with open(os.path.join(REPO, "tests", "golden",
                           "steplog_schema.json")) as fh:
        schema = json.load(fh)
    entry = schema["record_types"]["control_action"]
    assert entry["required"] == ["type", "knob", "old", "new",
                                 "reason", "t"]
    for opt in ("breaching_phase", "burn_rate_before", "rollback",
                "model"):
        assert opt in entry["optional"]


# -- registration surfaces: engine / scheduler --------------------------

def _mlp_bundle(tmp, name="mnist_mlp"):
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.models.vision import mlp
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import export_bundle

    reset_name_counters()
    out = mlp(hidden=(16, 8))
    params = Parameters.create(out, device="cpu")
    bundle_dir = str(tmp / (name + "_bundle"))
    export_bundle(out, params, bundle_dir, batch_sizes=(1, 4), name=name)
    return load_bundle(bundle_dir, device="cpu")


@pytest.fixture(scope="module")
def mlp_bundle(tmp_path_factory):
    return _mlp_bundle(tmp_path_factory.mktemp("control_mlp"))


def test_engine_register_knobs_applies_under_cv(mlp_bundle):
    from paddle_tpu_torch.serve import InferenceEngine

    # unbounded queue: only the deadline registers (adoption must not
    # silently impose a ceiling that was not configured)
    with InferenceEngine(mlp_bundle, max_latency_ms=5.0,
                         warmup=False) as eng:
        reg = KnobRegistry()
        eng.register_knobs(reg)
        assert reg.names() == ["engine.batch_deadline_ms"]
        assert reg.get("engine.batch_deadline_ms").value == 5.0
        reg.set("engine.batch_deadline_ms", 2.0)
        assert eng.stats()["max_latency_ms"] == 2.0
    with InferenceEngine(mlp_bundle, max_latency_ms=5.0,
                         max_queue_rows=32, warmup=False) as eng:
        reg = KnobRegistry()
        eng.register_knobs(reg)
        assert reg.names() == ["engine.batch_deadline_ms",
                               "engine.max_queue_rows"]
        knob = reg.get("engine.max_queue_rows")
        assert knob.value == 32 and knob.integer
        assert knob.min == eng.max_batch_size
        reg.set("engine.max_queue_rows", 8)
        assert eng.max_queue_rows == 8


# -- HTTP: GET /debug/control ------------------------------------------------

def test_http_debug_control_404_without_200_with(mlp_bundle):
    from paddle_tpu_torch.observe import health
    from paddle_tpu_torch.serve import InferenceEngine
    from paddle_tpu_torch.serve.server import serve_in_thread

    with InferenceEngine(mlp_bundle, warmup=False) as eng:
        server, _ = serve_in_thread(mlp_bundle, eng)
        base = "http://%s:%d" % server.server_address
        try:
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(base + "/debug/control",
                                       timeout=30)
            assert exc_info.value.code == 404
            body = json.load(exc_info.value)
            assert "--autotune" in body["error"]
        finally:
            server.shutdown()
            server.server_close()
    with InferenceEngine(mlp_bundle, warmup=False) as eng:
        knobs = KnobRegistry()
        eng.register_knobs(knobs)
        monitor = health.SloMonitor([eng], p99_ms=10_000.0)
        ctl = Controller(monitor, knobs)
        server, _ = serve_in_thread(mlp_bundle, eng, slo=monitor,
                                    controller=ctl)
        base = "http://%s:%d" % server.server_address
        try:
            snap = json.load(urllib.request.urlopen(
                base + "/debug/control", timeout=30))
            assert snap["enabled"] is False and snap["moves"] == 0
            assert "engine.batch_deadline_ms" in snap["knobs"]
            assert snap["actions"] == []
        finally:
            server.shutdown()
            server.server_close()


# -- slow: cli serve --autotune e2e + the audited slo-ab bench ---------------

def _subprocess_env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO
    env.setdefault("PADDLE_TPU_TORCH_LOG_LEVEL", "WARNING")
    return env


def test_cli_serve_autotune_serves_debug_control(mlp_bundle):
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
         mlp_bundle.directory, "--port", "0", "--device", "cpu",
         "--slo-p99-ms", "50", "--autotune"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_subprocess_env())
    try:
        banner = ""
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "serving" in line and "http" in line:
                banner = line
                break
        assert banner, "cli serve --autotune never came up"
        assert "/debug/control" in banner  # advertised only when live
        base = banner.split("http://", 1)[1].split(" ", 1)[0].strip()
        snap = json.load(urllib.request.urlopen(
            "http://%s/debug/control" % base, timeout=60))
        assert snap["enabled"] is True
        assert "engine.batch_deadline_ms" in snap["knobs"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_cli_serve_autotune_requires_an_objective(mlp_bundle):
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
         mlp_bundle.directory, "--port", "0", "--device", "cpu",
         "--autotune"],
        capture_output=True, text=True, env=_subprocess_env(),
        timeout=300)
    assert proc.returncode == 2
    assert "--slo-p99-ms" in proc.stderr


# -- the scheduler's knobs --------------------------------------------------

def test_scheduler_register_knobs_and_budgets(tmp_path):
    """The continuous scheduler adopts max_queue, idle_spill_ms and the
    admission/park budgets at their neutral ceilings, as the JAX
    scheduler does; a park budget of 0 spills every parked session
    without queue pressure, and an admit budget of 1 admits one fresh
    sequence a window."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import ContinuousScheduler, load_bundle
    from tests.torch_decode import GRU_BUILDER, SMALL, export_pair

    _, port_dir, _, _ = export_pair(tmp_path, GRU_BUILDER, SMALL,
                                    slots=(2,))
    bundle = load_bundle(port_dir, device="cpu")
    seqs = [np.arange(1, 7, dtype=np.int32), np.arange(2, 5,
                                                       dtype=np.int32)]
    with ContinuousScheduler(bundle, max_queue=8, idle_spill_ms=1000.0,
                             metrics_registry=MetricsRegistry()) as s:
        reg = KnobRegistry()
        s.register_knobs(reg)
        assert reg.names() == ["sched.admit_budget", "sched.idle_spill_ms",
                               "sched.max_queue", "sched.park_budget"]
        assert reg.get("sched.admit_budget").value == 2
        assert reg.get("sched.park_budget").cost_hint == "heavy"
        reg.set("sched.admit_budget", 1)
        futures = [s.submit({"word": q}) for q in seqs]
        for f in futures:
            f.result(timeout=60)
        assert s.admit_budget == 1
        s.infer({"word": seqs[0]}, session_id="a", timeout=60)
        assert s.stats()["resident_sessions"] == 1
        reg.set("sched.park_budget", 0)
        deadline = time.monotonic() + 30
        while s.stats()["resident_sessions"] and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = s.stats()
        assert stats["resident_sessions"] == 0 and stats["spills"] == 1


# -- the port's copy against the JAX module ---------------------------------

def _walk(mod, verdicts):
    """Feed ``verdicts`` (at one second apart) to a controller of
    ``mod`` over the same three knobs; returns its action tape and the
    knobs' final values."""
    reg = mod.KnobRegistry()
    reg.register(mod.Knob("engine.batch_deadline_ms", value=60.0,
                          min=0.25, max=500.0, step=0.5))
    reg.register(mod.Knob("engine.max_queue_rows", value=64, min=8,
                          max=1 << 20, step=8, integer=True))
    reg.register(mod.Knob("sched.idle_spill_ms", value=100.0, min=1.0,
                          max=600000.0, step=25.0))
    ctl = mod.Controller(None, reg, cooldown_s=3.0, hysteresis=2)
    for i, verdict in enumerate(verdicts):
        ctl.step(verdict, now=float(i))
    tape = [{k: v for k, v in a.items() if k != "unix_time"}
            for a in ctl.recent()]
    return tape, reg.snapshot(), (ctl.moves, ctl.rollbacks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_walks_match_jax(seed):
    rng = np.random.RandomState(seed)
    verdicts = []
    for _ in range(40):
        state = ["ok", "burning", "breached"][rng.randint(3)]
        phase = ["queue_ms", "dispatch_ms", "spill_restore_ms",
                 "decode_ms", None][rng.randint(5)]
        verdicts.append(_verdict(state=state, phase=phase,
                                 fast=float(rng.exponential(5.0))))
    from paddle_tpu_torch import control

    got = _walk(control, verdicts)
    want = _walk(jax_control, verdicts)
    assert got == want
    assert got[2][0] >= 1
