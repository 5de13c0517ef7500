"""Feedback control for the serving tier (paddle_tpu/control, kept as the
port's own copy: pure Python).

``observe/`` is the sensing half of the SLO loop — windowed health
history, burn-rate verdicts, tail attribution. This package is the
ACTUATION half: a declarative registry of live-adjustable serving
parameters (:mod:`paddle_tpu_torch.control.knobs`) and a controller thread
that moves them in response to burn-rate verdicts
(:mod:`paddle_tpu_torch.control.controller`), with hysteresis, per-knob
cooldowns, bounded step sizes, and a rollback guard.
"""

from paddle_tpu_torch.control.knobs import Knob, KnobRegistry
from paddle_tpu_torch.control.controller import Controller

__all__ = ["Knob", "KnobRegistry", "Controller"]
