"""Declarative registry of live-adjustable serving parameters.

A :class:`Knob` names ONE numeric parameter some serving component
(engine, scheduler, router, fleet, worker set) is willing to have
moved at runtime: its current value, the legal ``[min, max]`` range, a
base ``step`` granularity, and an ``apply`` hook that installs a new
value without racing the hot path. The hook is where thread safety
lives — each owner takes ITS OWN lock inside the hook (the engine's
condition variable, the router's lock), so a knob move observes the
same discipline as every other writer of that field. The knob never
reaches into the owner's state directly.

Components opt in by exposing ``register_knobs(registry)`` (duck
typed, like ``submit``/``stats`` on the engine interface); the CLI and
the controller call it on whatever front they serve. Registration is
behavior-neutral: a knob's initial value is the owner's current
setting, and owners whose parameter is unbounded (``None``) simply do
not register it — adoption must never silently impose a ceiling that
was not configured.

Names are dotted ``owner.parameter`` strings (``engine.
batch_deadline_ms``, ``sched.idle_spill_ms``, ``fleet.
active_replicas``); the controller's phase→knob-family map
(control/controller.py) keys on them, and a registry rejects
duplicates so two components can never fight over one name.
"""

import threading


class Knob:
    """One live-adjustable parameter: value, bounds, step, apply hook.

    ``set`` clamps to ``[min, max]`` (and the integer grid when
    ``integer=True``), invokes ``apply(new)`` — the owner's thread-safe
    installer — and only then records the new value, so a hook that
    raises leaves the knob's view consistent with the owner's.
    ``cost_hint`` tells the controller how disruptive a move is:
    ``"cheap"`` (a bound or deadline — takes effect next iteration)
    vs ``"heavy"`` (shifts load or memory, e.g. fleet width or park
    budget — worth a longer cooldown)."""

    def __init__(self, name, value, min, max, step=1.0, apply=None,
                 cost_hint="cheap", integer=False):
        if min > max:
            raise ValueError("knob %r: min %r > max %r" % (name, min, max))
        if step <= 0:
            raise ValueError("knob %r: step must be positive, got %r"
                             % (name, step))
        self.name = str(name)
        self.min = float(min)
        self.max = float(max)
        self.step = float(step)
        self.cost_hint = str(cost_hint)
        self.integer = bool(integer)
        self._apply = apply
        self._lock = threading.Lock()
        self._value = self._clamp(value)

    def _clamp(self, value):
        v = float(value)
        if v < self.min:
            v = self.min
        elif v > self.max:
            v = self.max
        if self.integer:
            v = float(int(round(v)))
        return v

    @property
    def value(self):
        with self._lock:
            return self._value

    def set(self, value):
        """Clamp, apply, record; returns ``(old, new)``. Serialized
        per knob so two concurrent movers cannot interleave their
        apply hooks and leave ``value`` describing neither."""
        with self._lock:
            old = self._value
            new = self._clamp(value)
            if self._apply is not None:
                self._apply(int(new) if self.integer else new)
            self._value = new
            return old, new

    def describe(self):
        return {"value": self.value, "min": self.min, "max": self.max,
                "step": self.step, "cost_hint": self.cost_hint,
                "integer": self.integer}

    def __repr__(self):
        return "Knob(%r, value=%s, min=%s, max=%s)" % (
            self.name, self.value, self.min, self.max)


class KnobRegistry:
    """Thread-safe name → :class:`Knob` table.

    The registry lock guards only the table; ``set`` resolves the knob
    under the lock then moves it OUTSIDE the lock, so a slow apply
    hook (a fleet-wide RPC fan-out) never blocks snapshots or other
    knobs' moves."""

    def __init__(self):
        self._lock = threading.Lock()
        self._knobs = {}

    def register(self, knob):
        with self._lock:
            if knob.name in self._knobs:
                raise ValueError("knob %r already registered" % knob.name)
            self._knobs[knob.name] = knob
        return knob

    def get(self, name):
        """The knob, or None — the controller probes for whichever
        members of a knob family this deployment actually registered."""
        with self._lock:
            return self._knobs.get(name)

    def names(self):
        with self._lock:
            return sorted(self._knobs)

    def set(self, name, value):
        """Move one knob by name; returns ``(old, new)``. KeyError for
        an unknown name (the worker RPC surfaces it by value)."""
        with self._lock:
            knob = self._knobs.get(name)
        if knob is None:
            raise KeyError(name)
        return knob.set(value)

    def snapshot(self):
        """JSON-able view of every knob — the ``/debug/control`` body's
        ``knobs`` half."""
        with self._lock:
            knobs = list(self._knobs.values())
        return {k.name: k.describe() for k in sorted(knobs,
                                                     key=lambda k: k.name)}

    def __len__(self):
        with self._lock:
            return len(self._knobs)
