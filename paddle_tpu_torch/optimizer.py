"""Optimizers: learning-rate schedules, the update base (clipping, L1/L2,
per-parameter learning-rate multipliers, update hooks, model averaging),
the seven update rules and the flat parameter pool (paddle_tpu/
optimizer.py; reference FirstOrderOptimizer.h, LearningRateScheduler.cpp,
ParameterUpdaterHook.cpp).

The update rules are the JAX package's, in float32 arithmetic on the
float32 master parameters: Momentum keeps ``v <- mu*v - lr*g; p <- p + v``
(not ``torch.optim.SGD``'s ``v <- mu*v + g; p <- p - lr*v``), Adam, Adamax,
AdaGrad, DecayedAdaGrad, AdaDelta and RMSProp keep the JAX defaults and
slot layouts (Adam's ``(m, v, t)`` and so on). Unlike the JAX package's
pure functions, ``step`` updates the parameters and the optimizer state IN
PLACE, under ``torch.no_grad()``: no tensor of the state is ever replaced,
so a captured CUDA graph of a train step (the trainer's ``steps_per_call``)
replays into the same memory.

For the same reason the step count lives on the device: ``state["step"]``
(and Adam's and Adamax's per-slot ``t``) is an int32 tensor, as in the JAX
package (paddle_tpu/optimizer.py:126, 181-182), and a learning-rate
schedule other than ``constant`` is computed from it on the device. A
graph replay then reads the step it is at, not the one it was captured at.

Sparse-row updates (paddle_tpu/optimizer.py:86-93, 119-173): a parameter
with ``ParamAttr(sparse_update=True)``, or every parameter of two or more
dims under ``Optimizer(sparse=True)``, updates only the rows whose
gradient has a nonzero entry this step. A row's step of last update is
kept in ``state["row_step"]`` (int32 per row); when a dormant row is next
touched, the L2 and L1 decay of the steps it missed is applied in one
shot before its update (the reference's catchUpWith), and the per-row
slots of untouched rows are left as they were.

``ParamPool`` keeps the small uniform parameters as views of ONE flat
float32 buffer (the JAX package's pool, paddle_tpu/optimizer.py:447-530:
the same entries, offsets and ``compatible_with`` rule); the trainer
gives their gradients views of one flat gradient buffer, so each
elementwise op of the update runs once over the whole pool.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod


def make_lr_schedule(learning_rate, learning_rate_decay_a=0.0,
                     learning_rate_decay_b=0.0,
                     learning_rate_schedule="constant"):
    """``step -> lr`` (LearningRateScheduler.cpp parity; step counts from 1
    at the first update). ``step`` is a float32 device tensor; the
    ``constant`` schedule gives a Python float, every other one a float32
    tensor on the step's device."""
    base = float(learning_rate)
    a, b = float(learning_rate_decay_a), float(learning_rate_decay_b)
    schedules = {
        "constant": lambda step: base,
        # lr * (1 + a*t)^(-b)
        "poly": lambda step: base * torch.pow(1.0 + a * step, -b),
        # lr * (1 - t/a)^b with t clipped to a
        "caffe_poly": lambda step: base * torch.pow(
            1.0 - torch.clamp(step, max=a) / a, b),
        # lr * a^(t/b)
        "exp": lambda step: base * torch.pow(a, step / b),
        # lr * a^floor(t/b)
        "discexp": lambda step: base * torch.pow(a, torch.floor(step / b)),
        # max(lr - a*t, b)
        "linear": lambda step: torch.clamp(base - a * step, min=b),
    }
    if learning_rate_schedule not in schedules:
        raise ValueError("unknown learning_rate_schedule %r"
                         % learning_rate_schedule)
    return schedules[learning_rate_schedule]


class Optimizer:
    """Base: schedules, clipping, L1/L2 decay, update hooks, model
    average. Per-parameter attributes (learning-rate multiplier, l1/l2
    override, clipping threshold, hooks) come in through ``param_meta``:
    ``{name: ParamAttr}``."""

    def __init__(self, learning_rate=1e-3, regularization=None,
                 gradient_clipping_threshold=None, model_average=None,
                 learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
                 learning_rate_schedule="constant", sparse=False,
                 slot_dtype=None):
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
        if model_average is not None and not isinstance(model_average,
                                                        float):
            model_average = model_average.decay
        self.model_average = model_average
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

    @staticmethod
    def _step_zero(param):
        """A slot's own step counter (Adam's ``t``): int32 on the device."""
        return torch.zeros((), dtype=torch.int32, device=param.device)

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
        device = next(iter(params.values())).device if params else None
        state = {"step": torch.zeros((), dtype=torch.int32, device=device),
                 "slots": {k: self.init_slot(v) for k, v in params.items()}}
        for k, v in params.items():
            for hook in getattr(param_meta.get(k), "update_hooks",
                                None) or ():
                hook.init_mask(k, v)
        row_step = {
            k: torch.zeros((v.shape[0],), dtype=torch.int32, device=v.device)
            for k, v in params.items()
            if v.dim() >= 1 and self._is_sparse_param(param_meta.get(k), v)}
        if row_step:
            state["row_step"] = row_step
        if self.model_average:
            state["average"] = {k: v.detach().clone()
                                for k, v in params.items()}
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
        last_step.copy_(torch.where(touched, step_no.to(last_step.dtype),
                                    last_step))

    @torch.no_grad()
    def step(self, params, grads, state, param_meta=None):
        """Apply one update in place to ``params`` (``{name: float32
        tensor}``) and ``state``. Returns (params, state)."""
        param_meta = param_meta or {}
        step_no = state["step"] + 1
        lr_t = self.lr_fn(step_no.to(torch.float32))
        row_steps = state.get("row_step", {})
        avg = state.get("average")
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
            if name in row_steps:
                self._sparse_row_step(grad, state["slots"][name], param, lr,
                                      l1, l2, row_steps[name], step_no)
            else:
                if l2:
                    grad = grad + l2 * param
                param.add_(self.apply_update(grad, state["slots"][name],
                                             param, lr))
                if l1:
                    # proximal L1 shrinkage (reference: L1Regularizer::update)
                    param.copy_(torch.sign(param) * torch.clamp(
                        param.abs() - lr * l1, min=0.0))
            for hook in getattr(attr, "update_hooks", None) or ():
                param.copy_(hook.apply(name, param))
            if avg is not None:
                decay = self.model_average
                avg[name].copy_(decay * avg[name] + (1.0 - decay) * param)
        state["step"].copy_(step_no)
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


class Adam(Optimizer):
    """reference: AdamParameterOptimizer (FirstOrderOptimizer.h:265)."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        kw.setdefault("learning_rate", 1e-3)
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init_slot(self, param):
        return (self._slot_zeros(param), self._slot_zeros(param),
                self._step_zero(param))

    def apply_update(self, grad, slot, param, lr):
        m, v, t = slot
        t.add_(1)
        new_m = self.b1 * m.float() + (1.0 - self.b1) * grad
        new_v = self.b2 * v.float() + (1.0 - self.b2) * grad * grad
        tf = t.to(grad.dtype)
        m_hat = new_m / (1.0 - torch.pow(self.b1, tf))
        v_hat = new_v / (1.0 - torch.pow(self.b2, tf))
        m.copy_(new_m)
        v.copy_(new_v)
        return -lr * m_hat / (torch.sqrt(v_hat) + self.eps)


class Adamax(Optimizer):
    """reference: AdamaxParameterOptimizer (FirstOrderOptimizer.h:303)."""

    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        kw.setdefault("learning_rate", 2e-3)
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def init_slot(self, param):
        return (self._slot_zeros(param), self._slot_zeros(param),
                self._step_zero(param))

    def apply_update(self, grad, slot, param, lr):
        m, u, t = slot
        t.add_(1)
        new_m = self.b1 * m.float() + (1.0 - self.b1) * grad
        new_u = torch.maximum(self.b2 * u.float(), grad.abs())
        tf = t.to(grad.dtype)
        m.copy_(new_m)
        u.copy_(new_u)
        return -lr / (1.0 - torch.pow(self.b1, tf)) * new_m / (new_u + 1e-12)


class AdaGrad(Optimizer):
    """reference: AdagradParameterOptimizer. ``slot_dtype`` is not applied
    (paddle_tpu/optimizer.py:315-322): the accumulator grows without
    bound, and a bfloat16 store would stop absorbing increments."""

    def __init__(self, epsilon=1e-6, **kw):
        kw.setdefault("learning_rate", 1e-2)
        super().__init__(**kw)
        self.eps = epsilon

    def init_slot(self, param):
        return (torch.zeros_like(param),)  # always f32: unbounded sum

    def apply_update(self, grad, slot, param, lr):
        (accum,) = slot
        accum.copy_(accum + grad * grad)
        return -lr * grad / (torch.sqrt(accum) + self.eps)


class DecayedAdaGrad(Optimizer):
    """reference: DecayedAdagradParameterOptimizer."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        kw.setdefault("learning_rate", 1e-2)
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_slot(self, param):
        return (self._slot_zeros(param),)

    def apply_update(self, grad, slot, param, lr):
        (accum,) = slot
        new = self.rho * accum.float() + (1.0 - self.rho) * grad * grad
        accum.copy_(new)
        return -lr * grad / (torch.sqrt(new) + self.eps)


class AdaDelta(Optimizer):
    """reference: AdaDeltaParameterOptimizer."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        kw.setdefault("learning_rate", 1.0)
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_slot(self, param):
        return (self._slot_zeros(param), self._slot_zeros(param))

    def apply_update(self, grad, slot, param, lr):
        accum_g, accum_x = slot
        new_g = self.rho * accum_g.float() + (1.0 - self.rho) * grad * grad
        update = -(torch.sqrt(accum_x.float() + self.eps)
                   / torch.sqrt(new_g + self.eps)) * grad
        new_x = self.rho * accum_x.float() \
            + (1.0 - self.rho) * update * update
        accum_g.copy_(new_g)
        accum_x.copy_(new_x)
        return lr * update


class RMSProp(Optimizer):
    """reference: RMSPropParameterOptimizer (with mean-subtracted
    variant)."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        kw.setdefault("learning_rate", 1e-3)
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_slot(self, param):
        return (self._slot_zeros(param), self._slot_zeros(param))

    def apply_update(self, grad, slot, param, lr):
        accum, mean = slot
        new_a = self.rho * accum.float() + (1.0 - self.rho) * grad * grad
        new_m = self.rho * mean.float() + (1.0 - self.rho) * grad
        accum.copy_(new_a)
        mean.copy_(new_m)
        return -lr * grad / torch.sqrt(new_a - new_m * new_m + self.eps)


class L2Regularization:
    def __init__(self, rate=0.0):
        self.l1, self.l2 = 0.0, float(rate)


class L1Regularization:
    def __init__(self, rate=0.0):
        self.l1, self.l2 = float(rate), 0.0


class Regularization:
    def __init__(self, l1=0.0, l2=0.0):
        self.l1, self.l2 = float(l1), float(l2)


class ModelAverage:
    """Exponential parameter averaging (reference: AverageOptimizer /
    ModelAverage in v2 optimizer settings): ``state["average"]`` follows
    ``decay * avg + (1 - decay) * param`` after every update."""

    def __init__(self, average_window=0.999):
        self.decay = float(average_window)


class StaticPruningHook:
    """Static magnitude pruning (reference: ParameterUpdaterHook.cpp
    StaticPruningHook, attached via ParamAttr(update_hooks=...)): a mask
    zeroing the smallest ``sparsity_ratio`` fraction of |w| is computed
    once from the initial values and re-applied after every update. The
    mask is computed on the host with the JAX package's numpy calls, so
    ties break by index the same way in both packages."""

    def __init__(self, sparsity_ratio=0.6):
        self.sparsity_ratio = float(sparsity_ratio)
        self._masks = {}

    def init_mask(self, name, param):
        flat = np.abs(param.detach().float().cpu().numpy()).reshape(-1)
        k = int(flat.size * self.sparsity_ratio)
        mask = np.ones_like(flat)
        if k > 0:
            # mask exactly k elements (ties broken by index) so constant
            # initializations aren't zeroed wholesale
            mask[np.argpartition(flat, k - 1)[:k]] = 0.0
        self._masks[name] = torch.as_tensor(
            mask.reshape(tuple(param.shape)), device=param.device)
        return self._masks[name]

    def apply(self, name, param):
        mask = self._masks.get(name)
        # a local replica on another card applies the same mask
        return param if mask is None else param * mask.to(param.device)


# ---------------------------------------------------------------------------
# flat master-parameter pool
# ---------------------------------------------------------------------------
class ParamPool:
    """Store the small uniform trainable parameters as ONE flat float32
    vector (paddle_tpu/optimizer.py ParamPool).

    Only SMALL parameters with default per-parameter behavior are pooled
    (float32, size <= max_entry_size, lr multiplier 1, no l1/l2 override,
    no clipping threshold, no sparse_update, no hooks), in sorted-name
    order; everything else stays per-name in the same dict, so
    ``Optimizer.step`` needs no changes: the pool is one more "parameter"
    under the reserved key. ``expand`` gives the pooled names as views of
    the flat buffer, so an in-place update of the pool is an update of
    every view. Callers disable pooling when the optimizer breaks
    uniformity (per-parameter-norm clipping, global sparse mode; see
    :func:`compatible_with`).
    """

    POOL_KEY = "__pool__"

    def __init__(self, params, param_meta=None, max_entry_size=4096):
        param_meta = param_meta or {}
        self.entries = []        # (name, offset, size, shape)
        self.special = []
        offset = 0
        for name in sorted(params):
            v = params[name]
            attr = param_meta.get(name)
            shape = tuple(getattr(v, "shape", ()))
            size = int(np.prod(shape)) if shape else 1
            if (self._uniform(attr) and _is_float32(v)
                    and size <= max_entry_size):
                self.entries.append((name, offset, size, shape))
                offset += size
            else:
                self.special.append(name)
        self.total = offset

    @staticmethod
    def _uniform(attr):
        if attr is None:
            return True
        return (getattr(attr, "learning_rate", 1.0) in (None, 1.0)
                and getattr(attr, "l1_rate", None) is None
                and getattr(attr, "l2_rate", None) is None
                and getattr(attr, "gradient_clipping_threshold", None) is None
                and not getattr(attr, "sparse_update", False)
                and not (getattr(attr, "update_hooks", None) or ()))

    @staticmethod
    def compatible_with(optimizer):
        """Pooling changes nothing numerically only when the optimizer has
        no per-parameter-norm behavior: gradient clipping computes ONE
        norm per parameter, and global sparse mode keys on row
        structure."""
        return optimizer.clip is None and not optimizer.sparse

    def enabled(self):
        return len(self.entries) >= 2

    # -- params ------------------------------------------------------------
    def compress(self, params):
        """{name: tensor} -> {POOL_KEY: a new flat float32 tensor,
        special...}."""
        flat = torch.cat([params[n].detach().reshape(-1).float()
                          for n, _, _, _ in self.entries])
        out = {self.POOL_KEY: flat}
        for n in self.special:
            out[n] = params[n]
        return out

    def expand(self, pooled):
        """Pooled dict -> full per-name dict (views of the pool)."""
        flat = pooled[self.POOL_KEY]
        out = {}
        for name, off, size, shape in self.entries:
            out[name] = flat[off:off + size].view(shape)
        for n in self.special:
            out[n] = pooled[n]
        return out

    # -- optimizer-state translation (per-name checkpoint format) ----------
    def _split_leaf(self, leaf, per_name):
        """Pool-shaped leaf -> {name: slice}; scalar/odd leaves replicate."""
        arr = np.asarray(leaf)
        for name, off, size, shape in self.entries:
            if arr.ndim == 1 and arr.shape[0] == self.total:
                per_name[name].append(arr[off: off + size].reshape(shape))
            else:
                per_name[name].append(arr)

    def unpool_state(self, state):
        """Optimizer state (numpy leaves) keyed by POOL_KEY -> per-name
        state (the checkpoint wire format)."""
        out = {k: v for k, v in state.items() if k not in ("slots",
                                                           "average")}
        slots = dict(state.get("slots", {}))
        pool_slot = slots.pop(self.POOL_KEY, None)
        if pool_slot is not None:
            per_name = {name: [] for name, _, _, _ in self.entries}
            for leaf in pool_slot:
                self._split_leaf(leaf, per_name)
            for name, _, _, _ in self.entries:
                slots[name] = tuple(per_name[name])
        out["slots"] = slots
        if "average" in state:
            avg = dict(state["average"])
            pool_avg = avg.pop(self.POOL_KEY, None)
            if pool_avg is not None:
                arr = np.asarray(pool_avg)
                for name, off, size, shape in self.entries:
                    avg[name] = arr[off: off + size].reshape(shape)
            out["average"] = avg
        return out

    def pool_state(self, state):
        """Per-name optimizer state (numpy leaves) -> pooled (inverse of
        unpool_state)."""
        out = {k: v for k, v in state.items() if k not in ("slots",
                                                           "average")}
        slots = dict(state.get("slots", {}))
        if self.enabled() and self.entries:
            per = [slots.pop(e[0]) for e in self.entries]
            pooled = []
            for i in range(len(per[0]) if per else 0):
                leaves = [np.asarray(p[i]) for p in per]
                if all(l.shape == e[3] for l, e in zip(leaves, self.entries)):
                    pooled.append(np.concatenate([l.ravel() for l in leaves]))
                else:  # scalar/odd leaves (e.g. Adam's step counter)
                    pooled.append(leaves[0])
            slots[self.POOL_KEY] = tuple(pooled)
        out["slots"] = slots
        if "average" in state:
            avg = dict(state["average"])
            vals = [avg.pop(e[0]) for e in self.entries if e[0] in avg]
            if vals:
                avg[self.POOL_KEY] = np.concatenate(
                    [np.asarray(v).ravel() for v in vals])
            out["average"] = avg
        return out


def _is_float32(value):
    if isinstance(value, torch.Tensor):
        return value.dtype == torch.float32
    return getattr(value, "dtype", None) == np.float32
