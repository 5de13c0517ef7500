"""Optimizers: learning-rate schedules, the update base (clipping, L1/L2,
per-parameter learning-rate multipliers) and Momentum (paddle_tpu/
optimizer.py; reference FirstOrderOptimizer.h, LearningRateScheduler.cpp).

The update rules are the JAX package's, in float32 arithmetic on the
float32 master parameters: Momentum keeps ``v <- mu*v - lr*g; p <- p + v``
(not ``torch.optim.SGD``'s ``v <- mu*v + g; p <- p - lr*v``). Unlike the
JAX package's pure functions, ``step`` updates the parameters and the
optimizer state IN PLACE, under ``torch.no_grad()``: it saves a copy of
every parameter and slot per step.

Sparse-row updates (paddle_tpu/optimizer.py:86-93, 119-173): a parameter
with ``ParamAttr(sparse_update=True)``, or every parameter of two or more
dims under ``Optimizer(sparse=True)``, updates only the rows whose
gradient has a nonzero entry this step. A row's step of last update is
kept in ``state["row_step"]`` (int32 per row); when a dormant row is next
touched, the L2 and L1 decay of the steps it missed is applied in one
shot before its update (the reference's catchUpWith), and the per-row
slots of untouched rows (momentum) are left as they were. Update hooks
and model averaging are not ported yet and raise; so do the other
optimizers, which come with later parts of the port.
"""

import math

import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.utils.error import enforce


def make_lr_schedule(learning_rate, learning_rate_decay_a=0.0,
                     learning_rate_decay_b=0.0,
                     learning_rate_schedule="constant"):
    """``step -> lr`` (LearningRateScheduler.cpp parity; step counts from 1
    at the first update)."""
    base = float(learning_rate)
    a, b = float(learning_rate_decay_a), float(learning_rate_decay_b)
    schedules = {
        "constant": lambda step: base,
        # lr * (1 + a*t)^(-b)
        "poly": lambda step: base * math.pow(1.0 + a * step, -b),
        # lr * (1 - t/a)^b with t clipped to a
        "caffe_poly": lambda step: base * math.pow(1.0 - min(step, a) / a,
                                                   b),
        # lr * a^(t/b)
        "exp": lambda step: base * math.pow(a, step / b),
        # lr * a^floor(t/b)
        "discexp": lambda step: base * math.pow(a, math.floor(step / b)),
        # max(lr - a*t, b)
        "linear": lambda step: max(base - a * step, b),
    }
    if learning_rate_schedule not in schedules:
        raise ValueError("unknown learning_rate_schedule %r"
                         % learning_rate_schedule)
    return schedules[learning_rate_schedule]


class Optimizer:
    """Base: schedules, clipping, L1/L2 decay. Per-parameter attributes
    (learning-rate multiplier, l1/l2 override, clipping threshold) come in
    through ``param_meta``: ``{name: ParamAttr}``."""

    def __init__(self, learning_rate=1e-3, regularization=None,
                 gradient_clipping_threshold=None, model_average=None,
                 learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
                 learning_rate_schedule="constant", sparse=False,
                 slot_dtype=None):
        enforce(model_average is None,
                "model averaging is not ported yet")
        self.lr_fn = make_lr_schedule(
            learning_rate, learning_rate_decay_a, learning_rate_decay_b,
            learning_rate_schedule)
        self.regularization = regularization
        self.clip = gradient_clipping_threshold
        # reduced-precision slots (e.g. bfloat16 momentum): the update
        # arithmetic stays float32, slots are upcast on read and rounded on
        # store; the parameters keep full precision
        self.slot_dtype = dtype_mod.canonical(slot_dtype) if slot_dtype \
            else None
        # sparse-row mode for every parameter of 2+ dims (a bias element
        # whose gradient is exactly 0 must not be frozen); one parameter
        # opts in with ParamAttr(sparse_update=True)
        self.sparse = bool(sparse)

    # slots -----------------------------------------------------------------
    def init_slot(self, param):
        """Per-parameter optimizer slots (a tuple of tensors)."""
        return ()

    def _slot_zeros(self, param):
        return torch.zeros(param.shape, dtype=self.slot_dtype or param.dtype,
                           device=param.device)

    def apply_update(self, grad, slot, param, lr):
        """One parameter's update: returns the delta (new param = param +
        delta) and writes the new slot values into ``slot`` in place."""
        raise NotImplementedError

    # full step -------------------------------------------------------------
    def _is_sparse_param(self, attr, param):
        if getattr(attr, "sparse_update", False):
            return True
        return self.sparse and param.dim() >= 2

    def init_state(self, params, param_meta=None):
        param_meta = param_meta or {}
        for name in params:
            attr = param_meta.get(name)
            enforce(not (getattr(attr, "update_hooks", None) or ()),
                    "parameter %r: update hooks are not ported yet", name)
        state = {"step": 0,
                 "slots": {k: self.init_slot(v) for k, v in params.items()}}
        row_step = {
            k: torch.zeros((v.shape[0],), dtype=torch.int32, device=v.device)
            for k, v in params.items()
            if v.dim() >= 1 and self._is_sparse_param(param_meta.get(k), v)}
        if row_step:
            state["row_step"] = row_step
        return state

    def _sparse_row_step(self, grad, slot, param, lr, l1, l2, last_step,
                         step_no):
        """Update the rows of ``param`` touched this step (any nonzero
        gradient entry) in place, with the L2 and L1 decay of the steps
        each missed since its last update applied first; the per-row slots
        and ``last_step`` of untouched rows are kept as they were."""
        touched = (grad != 0).reshape(grad.shape[0], -1).any(dim=1)
        mask = touched.reshape((-1,) + (1,) * (grad.dim() - 1))
        missed = (step_no - last_step).to(param.dtype).reshape(mask.shape)
        p = param
        if l2:
            p = p * torch.pow(1.0 - lr * l2, torch.where(
                mask, missed, torch.zeros_like(missed)))
        if l1:
            shrunk = torch.sign(p) * torch.clamp(
                p.abs() - lr * l1 * missed, min=0.0)
            p = torch.where(mask, shrunk, p)
        old = [t.clone() for t in slot]
        delta = self.apply_update(grad, slot, p, lr)
        for new, was in zip(slot, old):
            if new.dim() >= 1 and new.shape[0] == mask.shape[0]:
                # only per-row slots are masked; a global slot (a scalar
                # step counter) always advances
                new.copy_(torch.where(mask, new, was))
        param.copy_(torch.where(mask, p + delta, param))
        last_step.copy_(torch.where(touched, torch.full_like(
            last_step, step_no), last_step))

    @torch.no_grad()
    def step(self, params, grads, state, param_meta=None):
        """Apply one update in place to ``params`` (``{name: float32
        tensor}``) and ``state``. Returns (params, state)."""
        param_meta = param_meta or {}
        step_no = state["step"] + 1
        lr_t = self.lr_fn(float(step_no))
        for name, param in params.items():
            grad = grads[name].float()
            attr = param_meta.get(name)
            lr_mult = getattr(attr, "learning_rate", 1.0) if attr else 1.0
            clip = (getattr(attr, "gradient_clipping_threshold", None)
                    if attr else None) or self.clip
            if clip:
                norm = torch.linalg.vector_norm(grad)
                grad = grad * torch.clamp(clip / torch.clamp(norm, min=1e-12),
                                          max=1.0)
            l1 = getattr(attr, "l1_rate", None) if attr else None
            l2 = getattr(attr, "l2_rate", None) if attr else None
            if self.regularization is not None:
                l1 = self.regularization.l1 if l1 is None else l1
                l2 = self.regularization.l2 if l2 is None else l2
            lr = lr_t * lr_mult
            if name in state.get("row_step", {}):
                self._sparse_row_step(grad, state["slots"][name], param, lr,
                                      l1, l2, state["row_step"][name],
                                      step_no)
                continue
            if l2:
                grad = grad + l2 * param
            param.add_(self.apply_update(grad, state["slots"][name], param,
                                         lr))
            if l1:
                # proximal L1 shrinkage (reference: L1Regularizer::update)
                param.copy_(torch.sign(param) * torch.clamp(
                    param.abs() - lr * l1, min=0.0))
        state["step"] = step_no
        return params, state


class Momentum(Optimizer):
    """SGD with (optionally Nesterov) momentum (reference: SgdOptimizer /
    SparseMomentumParameterOptimizer; v2 optimizer.Momentum)."""

    def __init__(self, momentum=0.0, sparse=False, nesterov=False, **kw):
        super().__init__(sparse=sparse, **kw)
        self.mu = float(momentum)
        self.nesterov = nesterov

    def init_slot(self, param):
        if self.mu == 0.0:
            return ()
        return (self._slot_zeros(param),)

    def apply_update(self, grad, slot, param, lr):
        if self.mu == 0.0:
            return -lr * grad
        (vel,) = slot
        new_vel = self.mu * vel.float() - lr * grad
        vel.copy_(new_vel)  # rounded to slot_dtype on store
        if self.nesterov:
            return self.mu * new_vel - lr * grad
        return new_vel


SGD = Momentum


class L2Regularization:
    def __init__(self, rate=0.0):
        self.l1, self.l2 = 0.0, float(rate)


class L1Regularization:
    def __init__(self, rate=0.0):
        self.l1, self.l2 = float(rate), 0.0


class Regularization:
    def __init__(self, l1=0.0, l2=0.0):
        self.l1, self.l2 = float(l1), float(l2)
