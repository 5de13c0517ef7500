"""The SLO controller: burn-rate verdicts in, knob moves out.

One named daemon thread (``slo-controller``) closes the SLO loop: it
consumes :class:`~paddle_tpu_torch.observe.health.SloMonitor`
verdicts — burn rates over the merged fleet history plus the tracing
exemplar reservoir's tail attribution — and maps the breaching phase
to a knob *family* (docs/control.md):

- ``queue_ms``-dominated tails: widen the fleet if a width knob is
  registered, else shed earlier (lower the queue ceilings) — queued
  work the deadline cannot absorb should be refused, not aged; when
  neither lever exists (a bare engine), tighten the batch deadline —
  the whole-request engine bills its deadline hold into ``queue_ms``
  (enqueue -> batch launch), so on that deployment shape the deadline
  IS the queue-wait lever, and the rollback guard reverts the move if
  the tail was genuine overload that batching was absorbing;
- ``spill_restore_ms``-dominated: spill less aggressively (raise
  ``idle_spill_ms``, raise the park budget);
- ``dispatch_ms``-dominated: grow the decode window's admission
  budget so each dispatch carries more concurrent work;
- ``batch_form_ms``-dominated: tighten the batch deadline — the
  engine is holding requests open to build batches the SLO cannot
  afford;
- ``decode_ms``-dominated: admit less per iteration.

Safety rails, in order of application: **hysteresis** (a move needs N
consecutive breaching verdicts — one bad scrape is noise), **per-knob
cooldown** (a moved knob rests while its effect reaches the windowed
history; ``heavy`` knobs rest twice as long), **bounded steps** (each
move is at most ``rel_step`` of the current value, floored at the
knob's step and capped at ``max_step_mult`` steps), and a **rollback
guard** — the controller remembers the burn rate each move was
supposed to improve and, if the next verdict is *worse* by more than
``rollback_factor``, reverts the move and benches that knob for a
double cooldown. At most one knob moves per verdict.

Every move (rollbacks included) is logged as an additive schema-v1
``control_action`` steplog record and mirrored onto the
``paddle_tpu_control_*`` metric families, so ``cli observe`` can
print the knob-move timeline next to the tail-attribution report and
a scrape can alarm on controller thrash.
"""

import collections
import threading
import time

# Breaching phase -> ordered plays: (knob name, direction, reason).
# The controller walks each family in order and moves the FIRST
# registered knob that is off cooldown and not already at its bound —
# deployment shape decides which member exists (a single engine has no
# fleet.active_replicas; a whole-request engine has no sched.* knobs).
PHASE_PLAYS = {
    "queue_ms": (
        ("fleet.active_replicas", +1, "widen_fleet"),
        ("sched.max_queue", -1, "shed_earlier"),
        ("engine.max_queue_rows", -1, "shed_earlier"),
        ("router.shed_normal", -1, "shed_earlier"),
        ("router.shed_low", -1, "shed_earlier"),
        # last resort, and the ONLY queue lever on a bare engine: the
        # whole-request engine's queue_ms phase is enqueue -> batch
        # launch, so the deadline hold is billed there, not to
        # batch_form_ms (engine._run_batch's phase clock)
        ("engine.batch_deadline_ms", -1, "tighten_deadline"),
    ),
    "spill_restore_ms": (
        ("sched.idle_spill_ms", +1, "spill_later"),
        ("sched.park_budget", +1, "park_more"),
    ),
    "dispatch_ms": (
        ("sched.admit_budget", +1, "grow_window"),
    ),
    "decode_ms": (
        ("sched.admit_budget", -1, "shrink_window"),
    ),
    "batch_form_ms": (
        ("engine.batch_deadline_ms", -1, "tighten_deadline"),
    ),
}

_BREACHING = ("burning", "breached")


class Controller:
    """Feedback controller over a :class:`~paddle_tpu_torch.control.knobs
    .KnobRegistry`, driven by SloMonitor verdicts.

    ``step(verdict)`` is the whole decision cycle and is deterministic
    given the verdict stream and ``now`` — tests walk scripted
    histories through it without threads or clocks. ``start()`` runs
    it on the named daemon-thread cadence for production."""

    def __init__(self, monitor, knobs, interval_s=5.0, cooldown_s=30.0,
                 hysteresis=2, rel_step=0.25, max_step_mult=16,
                 rollback_factor=1.1, slog=None, registry=None,
                 model=None, history=64):
        self.monitor = monitor
        self.knobs = knobs
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.hysteresis = int(hysteresis)
        self.rel_step = float(rel_step)
        self.max_step_mult = float(max_step_mult)
        self.rollback_factor = float(rollback_factor)
        self.model = model
        self._slog = slog
        self._registry = registry
        self._lock = threading.Lock()
        self._streak = 0
        self._cooldowns = {}   # knob name -> monotonic ts it rests until
        self._pending = None   # last move awaiting its rollback verdict
        self._actions = collections.deque(maxlen=int(history))
        self.moves = 0
        self.rollbacks = 0
        self._stop_evt = threading.Event()
        self._thread = None

    # -- decision cycle ------------------------------------------------------
    def step(self, verdict, now=None):
        """One decision cycle over one verdict; returns the action dict
        applied this cycle (rollbacks included) or None."""
        if now is None:
            now = time.monotonic()
        state = verdict.get("state")
        breaching = state in _BREACHING
        fast_burn = float(verdict.get("burn_rates", {}).get("fast", 0.0))
        with self._lock:
            action = self._judge_pending_locked(verdict, fast_burn, now)
            if action is None:
                if not breaching:
                    self._streak = 0
                    return None
                self._streak += 1
                if self._streak < self.hysteresis:
                    return None
                action = self._decide_locked(verdict, fast_burn, now)
                if action is None:
                    return None
        self._publish(action)
        return action

    def _judge_pending_locked(self, verdict, fast_burn, now):
        """Rollback guard: the verdict AFTER a move judges it. Worse
        fast burn (beyond the tolerance factor) while still breaching
        means the move hurt — revert it and bench the knob."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        worse = (verdict.get("state") in _BREACHING
                 and fast_burn > pending["burn_rate_before"]
                 * self.rollback_factor)
        if not worse:
            return None
        try:
            old, new = self.knobs.set(pending["knob"], pending["old"])
        except KeyError:
            return None  # knob vanished (worker died): nothing to revert
        self._cooldowns[pending["knob"]] = now + 2.0 * self.cooldown_s
        self._streak = 0
        self.rollbacks += 1
        return self._record_locked(
            pending["knob"], old, new, "rollback",
            breaching_phase=verdict.get("breaching_phase"),
            burn_rate_before=fast_burn, rollback=True)

    def _decide_locked(self, verdict, fast_burn, now):
        """Map the breaching phase to its knob family and move the
        first actionable member. cv-free but under the controller
        lock; knob application itself takes the owner's lock inside
        the apply hook."""
        plays = PHASE_PLAYS.get(verdict.get("breaching_phase"))
        if not plays:
            return None
        severity = 2.0 if verdict.get("state") == "breached" else 1.0
        for name, direction, reason in plays:
            knob = self.knobs.get(name)
            if knob is None:
                continue
            if self._cooldowns.get(name, 0.0) > now:
                continue
            current = knob.value
            magnitude = max(knob.step, self.rel_step * abs(current))
            magnitude = min(magnitude * severity,
                            knob.step * self.max_step_mult)
            old, new = knob.set(current + direction * magnitude)
            if new == old:
                continue  # already pinned at the bound: next play
            cooldown = self.cooldown_s * (2.0 if knob.cost_hint == "heavy"
                                          else 1.0)
            self._cooldowns[name] = now + cooldown
            self._streak = 0
            self.moves += 1
            self._pending = {"knob": name, "old": old, "new": new,
                             "burn_rate_before": fast_burn}
            return self._record_locked(
                name, old, new, reason,
                breaching_phase=verdict.get("breaching_phase"),
                burn_rate_before=fast_burn, rollback=False)
        return None

    def _record_locked(self, knob, old, new, reason, breaching_phase,
                       burn_rate_before, rollback):
        entry = {"knob": knob, "old": old, "new": new, "reason": reason,
                 "breaching_phase": breaching_phase,
                 "burn_rate_before": round(float(burn_rate_before), 4),
                 "rollback": rollback, "unix_time": time.time()}
        self._actions.append(entry)
        return entry

    def _publish(self, action):
        """Steplog + metrics mirroring, outside the controller lock —
        telemetry loss must not wedge the loop."""
        try:
            if self._slog is not None:
                self._slog.log_control_action(
                    knob=action["knob"], old=action["old"],
                    new=action["new"], reason=action["reason"],
                    breaching_phase=action["breaching_phase"],
                    burn_rate_before=action["burn_rate_before"],
                    rollback=action["rollback"] or None,
                    model=self.model)
            if self._registry is not None:
                from paddle_tpu_torch.observe.metrics import control_instruments

                inst = control_instruments(self._registry,
                                           knob=action["knob"])
                inst["actions"].inc()
                inst["knob_value"].set(action["new"])
                if action["rollback"]:
                    inst["rollbacks"].inc()
        except Exception:  # noqa: BLE001 — lose telemetry, not the loop
            from paddle_tpu_torch.utils.logger import logger

            logger.exception("control action publication failed")

    # -- surfaces ------------------------------------------------------------
    def recent(self, n=20):
        """Most-recent actions, newest last (``/debug/control`` and
        the slo-ab bench's audit both read this)."""
        with self._lock:
            return list(self._actions)[-int(n):]

    def snapshot(self):
        """The ``GET /debug/control`` body: every knob's current
        value/bounds plus the recent action tape."""
        with self._lock:
            running = self._thread is not None
            moves, rollbacks = self.moves, self.rollbacks
        return {"enabled": running, "interval_s": self.interval_s,
                "cooldown_s": self.cooldown_s,
                "hysteresis": self.hysteresis,
                "moves": moves, "rollbacks": rollbacks,
                "knobs": self.knobs.snapshot(),
                "actions": self.recent()}

    # -- thread --------------------------------------------------------------
    def start(self):
        """Run the decision cycle on a named daemon-thread cadence."""
        with self._lock:
            if self._thread is not None:
                return self
            thread = threading.Thread(target=self._loop,
                                      name="slo-controller",
                                      daemon=True)
            self._thread = thread
        self._stop_evt.clear()
        thread.start()
        return self

    def _loop(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.step(self.monitor.evaluate())
            except Exception:  # noqa: BLE001 — the loop must outlive a bad verdict
                from paddle_tpu_torch.utils.logger import logger

                logger.exception("controller decision cycle failed")

    def stop(self):
        self._stop_evt.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
