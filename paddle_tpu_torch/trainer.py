"""The SGD trainer: the v2 event loop around one eager train step
(paddle_tpu/trainer.py; reference python/paddle/v2/trainer.py SGD.train and
TrainerInternal::trainOneBatch).

One step: ``Topology.apply(mode="train")`` over the cost layers, the mean
cost over the batch (``paddle_tpu/trainer.py:123``), ``backward()`` (each
``lstmemory`` through the LSTM backward kernel), then the optimizer's
in-place update of the float32 master parameters. Under the mixed-precision
policy (``core.dtype.set_mixed_precision("bfloat16")``) the forward casts
the masters to bfloat16 at the topology boundary and their gradients come
back float32 through the cast; no bfloat16 copy of the masters is kept.

The event stream is the JAX package's, one step deep: BeginPass, then per
batch BeginIteration(b); batch b-1 is finalized (its cost read back,
EndForwardBackward(b-1), EndIteration(b-1)) after step b is queued, so the
host enqueues the next step while the card runs the last; then EndPass.
With a ``test_reader``, the ``test_period`` flag (paddle_tpu/trainer.py:
557-575, 644-650) runs a test pass every ``test_period`` global steps and
emits its TestResult when that step is finalized, before its
EndIteration; at 0 (the default) one test pass runs at the end of every
pass instead. The ``log_period`` flag logs the cost of every
``log_period``-th batch of a pass.

Sparse-row parameters (``ParamAttr(sparse_update=True)``, or
``Momentum(sparse=True)`` for every matrix) carry the optimizer's
``row_step`` in its state; their gradient is dense, as the JAX package's
scatter-add is, and the optimizer updates only the rows it touches.

Running state (batch norm's moving mean and variance, ``ParamSpec
.is_state``) lives on the device beside the masters, float32, outside
autograd and the optimizer: each step's train-mode forward reports the new
values (``Topology.apply(state_updates=...)``) and they replace the old
ones, detached, after the update, as the JAX trainer's
``{**state, **updates}``. ``test()`` and the bundle export read them, and
``_sync_back`` hands them back to the Parameters object with the masters.

Dropout draws its masks from the trainer's own ``torch.Generator`` on
its device, seeded from the ``seed`` flag when the trainer is built
(paddle_tpu/trainer.py:231, a JAX key split per step there); every
train-mode step draws from it in turn, so a trainer's run is reproducible
from the seed.

The trainer runs on ``device`` (the card unless ``device="cpu"``; it
raises without a card) and stages the given Parameters there. Not ported
yet, and refused rather than ignored: evaluators (``extra_layers``), data
parallelism, and the ``train`` options for the feed pipeline, bucketing,
the fused K-step loop and checkpoints.
"""

import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger

# paddle_tpu.trainer.SGD.train options this port refuses unless left off
_UNPORTED_TRAIN_ARGS = {
    "feed_pipeline": False, "buckets": None, "steps_per_call": None,
    "checkpoint_dir": None, "checkpoint_every": 0, "checkpoint_keep": 3,
    "resume": False, "checkpoint_sync": False}


class SGD:
    """v2-API trainer. ``update_equation`` is a paddle_tpu_torch.optimizer
    Optimizer."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True, feeding=None, parallelism=None, device=None):
        enforce(isinstance(parameters, Parameters),
                "parameters must be a Parameters object")
        enforce(isinstance(update_equation, Optimizer),
                "update_equation must be an Optimizer")
        enforce(not extra_layers,
                "SGD(extra_layers=...): evaluators are not ported yet")
        enforce(parallelism is None,
                "SGD(parallelism=...): data parallelism is not ported yet")
        self.device = resolve_device(device)
        self.costs = [cost] if isinstance(cost, LayerNode) else list(cost)
        self.topology = Topology(self.costs)
        self.parameters = parameters
        self.optimizer = update_equation
        self.feeding = feeding
        trainable, static, state = parameters.partition()
        self._param_meta = {n: parameters.spec(n).attr
                            for n in trainable + static
                            if parameters.spec(n) is not None}
        values = parameters.as_dict()
        # the trainer's own float32 masters on its device (the Parameters
        # object gets them back at the end of every pass)
        self._trainable = {
            n: values[n].detach().to(self.device, torch.float32).clone()
            .requires_grad_() for n in trainable}
        self._static = {n: values[n].detach().to(self.device)
                        for n in static}
        self._state = {n: values[n].detach().to(self.device, torch.float32)
                       for n in state}
        self._opt_state = update_equation.init_state(self._trainable,
                                                     self._param_meta)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(flags.get_flag("seed") or 0))
        self._step_count = 0  # global steps, across passes and train calls

    # -- main loop ----------------------------------------------------------
    def train(self, reader, num_passes=1, event_handler=None, feeding=None,
              sync_params=True, test_reader=None, **options):
        """Event-driven training (v2 SGD.train parity). ``reader`` yields
        minibatches (lists of sample tuples); with ``test_reader`` a test
        pass runs every ``test_period`` steps (the flag), or at the end of
        every pass when it is 0."""
        for key, value in options.items():
            if key not in _UNPORTED_TRAIN_ARGS:
                raise TypeError("train() got an unexpected keyword argument "
                                "%r" % key)
            off = _UNPORTED_TRAIN_ARGS[key]
            enforce(value == off or (not value and not off),
                    "train(%s=%r) is not ported yet", key, value)
        event_handler = event_handler or default_event_handler
        feeding = feeding or self.feeding
        log_period = flags.get_flag("log_period")
        test_period = (flags.get_flag("test_period")
                       if test_reader is not None else 0)

        def finalize(pending):
            """Read back a queued step's cost and emit its events: the
            periodic log line and test pass come between
            EndForwardBackward and EndIteration, as in the JAX trainer."""
            pass_id, batch_id, loss, step = pending
            cost = float(loss)
            event_handler(v2_event.EndForwardBackward(pass_id, batch_id,
                                                      gm=self))
            if log_period and batch_id % log_period == 0:
                logger.info("pass %d batch %d cost=%.6f", pass_id, batch_id,
                            cost)
            if test_period and step % test_period == 0:
                result = self.test(test_reader, feeding=feeding,
                                   pass_id=pass_id)
                logger.info("periodic test: cost=%.6f", result.cost)
                event_handler(result)
            event_handler(v2_event.EndIteration(pass_id, batch_id, cost, {}))

        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            pending = None
            for batch_id, data_batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                # a batch may carry the padded length of its bucket
                # (``data_batch.bucket``), as in the JAX trainer
                feed = convert_feed(self.topology, data_batch, self.device,
                                    feeding,
                                    max_len=getattr(data_batch, "bucket",
                                                    None))
                loss = self._train_step(feed)
                self._step_count += 1
                if pending is not None:
                    finalize(pending)
                pending = (pass_id, batch_id, loss, self._step_count)
            if pending is not None:
                finalize(pending)
            if test_reader is not None and not test_period:
                event_handler(self.test(test_reader, feeding=feeding,
                                        pass_id=pass_id))
            if sync_params:
                self._sync_back()
            event_handler(v2_event.EndPass(pass_id, {}, gm=self))

    def _cost(self, feed, mode, state_updates=None):
        """The batch's cost: the sum over the cost layers of their mean
        per-sample cost (paddle_tpu/trainer.py:123)."""
        values = self.topology.apply(
            {**self._trainable, **self._static, **self._state}, feed,
            mode=mode, outputs=[c.name for c in self.costs],
            state_updates=state_updates, generator=self._generator)
        return sum(values[c.name].float().mean() for c in self.costs)

    def _train_step(self, feed):
        """Forward, backward and update of one batch; returns the cost as
        a device scalar (not read back)."""
        for p in self._trainable.values():
            p.grad = None
        updates = {}
        loss = self._cost(feed, "train", state_updates=updates)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self._trainable.items()}
        self.optimizer.step(self._trainable, grads, self._opt_state,
                            self._param_meta)
        for name, value in updates.items():
            self._state[name] = value.detach().float()
        return loss.detach()

    def test(self, reader, feeding=None, pass_id=0):
        """One evaluation pass; returns a TestResult event (v2 SGD.test)."""
        feeding = feeding or self.feeding
        total, n_batches = 0.0, 0
        for data_batch in reader():
            feed = convert_feed(self.topology, data_batch, self.device,
                                feeding)
            total += float(self._cost(feed, "test"))
            n_batches += 1
        return v2_event.TestResult(pass_id, total / max(n_batches, 1), {})

    # -- parameters ---------------------------------------------------------
    def _sync_back(self):
        """Copy the trained masters and the running state back into the
        Parameters object."""
        self.parameters.update_from({**self._trainable, **self._state})

    def save_parameter_to_tar(self, f):
        self._sync_back()
        self.parameters.to_tar(f)

    def export_inference_bundle(self, builder, out_dir, **export_kw):
        """Sync the trained parameters back and export a serving bundle of
        the topology ``builder`` builds (``"module.path:function"`` or a
        manifest builder entry; serve/export.py export_bundle kwargs pass
        through). The bundle carries the trained parameters that topology
        reads (export_bundle's ``trained=True``)."""
        from paddle_tpu_torch.serve.export import export_bundle

        self._sync_back()
        return export_bundle(builder, self.parameters, out_dir, trained=True,
                             **export_kw)


def default_event_handler(evt):
    pass
