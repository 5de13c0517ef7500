"""The SGD trainer: the v2 event loop around one train step
(paddle_tpu/trainer.py; reference python/paddle/v2/trainer.py SGD.train and
TrainerInternal::trainOneBatch).

One step: ``Topology.apply(mode="train")`` over the cost layers and the
evaluators, the mean cost over the batch (``paddle_tpu/trainer.py:123``),
``backward()`` (each ``lstmemory`` through the LSTM backward kernel), then
the optimizer's in-place update of the float32 master parameters. Under
the mixed-precision policy (``core.dtype.set_mixed_precision("bfloat16")``)
the forward casts the masters to bfloat16 at the topology boundary and
their gradients come back float32 through the cast.

Every tensor of the training state is updated IN PLACE and never
replaced: the masters, their gradients where they are pooled, the
optimizer's slots and step count (int32 on the device), the running state
(batch norm's moving statistics, written from each step's
``Topology.apply(state_updates=...)``). A captured CUDA graph of a step
therefore replays into the same memory.

``ParamPool`` (optimizer.py): the small uniform trainables are views of
one flat float32 buffer and their gradients views of one flat gradient
buffer, so the update runs once over the pool; every other parameter is a
tensor of its own. Update hooks (``StaticPruningHook``) prune the initial
masters too, after the optimizer state has been made from them
(paddle_tpu/trainer.py:221-230).

The event stream is the JAX package's, one step deep: BeginPass, then per
batch BeginIteration(b); batch b-1 is finalized (its cost and evaluator
statistics read back, EndForwardBackward(b-1), EndIteration(b-1) with the
evaluators' metrics) after step b is queued, so the host enqueues the next
step while the card runs the last; then EndPass with the pass's metrics.
With a ``test_reader``, the ``test_period`` flag runs a test pass every
``test_period`` global steps, or at 0 (the default) one at the end of
every pass. The ``log_period`` flag logs the cost of every
``log_period``-th batch of a pass.

``train`` takes the JAX package's options: ``buckets`` (data/bucketing.py
``rebucket_batches``), ``feed_pipeline`` (data/feeder.py ``DeviceFeeder``,
pinned host batches copied ahead of the step), ``steps_per_call=K`` (the
fused loop: on the card each chunk of K same-shape feeds runs as ONE
captured CUDA graph of the K steps; on the CPU as a loop of the same step
function, with the same chunking and events) and durable checkpoints
(``checkpoint_dir``, ``checkpoint_every``, ``checkpoint_keep``,
``resume``, ``checkpoint_sync``; distributed/checkpoint.py, the JAX
package's format).

Dropout draws its masks from the trainer's own ``torch.Generator`` on its
device, seeded from the ``seed`` flag; a captured graph registers it, so
each replay advances it as the eager steps would. A checkpoint stores its
state where the JAX package stores its threefry key, so a resumed run
draws the masks the uninterrupted one would have drawn.

The trainer runs on ``device`` (the card unless ``device="cpu"``; it
raises without a card). Not ported yet, and refused: data parallelism
(``parallelism``), ``MultiNetwork`` costs and the save election
(``save_checkpoint(coordinator=)``).
"""

import itertools
import os
import time

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.evaluator import host_stats
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.optimizer import Optimizer, ParamPool
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger


def kernel_launch_counts():
    """The launch counts of every hand-written kernel's wrapper, by
    library name (each wrapper adds one where it launches its kernel)."""
    from paddle_tpu_torch.ops import conv_kernels as ck
    from paddle_tpu_torch.ops import gru_kernels as gk
    from paddle_tpu_torch.ops import int8_kernels as ik
    from paddle_tpu_torch.ops import lstm_kernels as lk

    return {"lstm_seq_fwd": lk.launches, "lstm_seq_bwd": lk.bwd_launches,
            "gru_seq_fwd": gk.launches, "gru_seq_bwd": gk.bwd_launches,
            "conv2d_same_fwd": ck.launches,
            "conv2d_same_bwdw": ck.bwdw_launches,
            "int8_matmul": ik.launches}


def _tree_tensors(tree):
    """Every tensor of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _copy_into(live, values):
    """Copy a numpy/tensor tree ``values`` into the live tensors of the
    same structure, in place."""
    if isinstance(live, dict):
        for k, v in live.items():
            _copy_into(v, values[k])
    elif isinstance(live, (list, tuple)):
        for v, new in zip(live, values):
            _copy_into(v, new)
    elif isinstance(live, torch.Tensor):
        live.copy_(torch.as_tensor(np.asarray(values)).to(live.dtype))


class SGD:
    """v2-API trainer. ``update_equation`` is a paddle_tpu_torch.optimizer
    Optimizer; ``extra_layers`` are evaluators (paddle_tpu_torch.evaluator)
    and extra outputs."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True, feeding=None, parallelism=None, device=None):
        enforce(isinstance(parameters, Parameters),
                "parameters must be a Parameters object")
        enforce(isinstance(update_equation, Optimizer),
                "update_equation must be an Optimizer")
        enforce(parallelism is None,
                "SGD(parallelism=...): data parallelism is not ported yet")
        extra = ([extra_layers] if isinstance(extra_layers, LayerNode)
                 else list(extra_layers or []))
        enforce(all(isinstance(e, LayerNode) for e in extra),
                "SGD(extra_layers=...) takes layers (evaluators or extra "
                "outputs), got %r", extra)
        self.device = resolve_device(device)
        self.costs = [cost] if isinstance(cost, LayerNode) else list(cost)
        self.evaluators = [e for e in extra
                           if getattr(e, "is_evaluator", False)]
        self.extra_outputs = [e for e in extra
                              if not getattr(e, "is_evaluator", False)]
        self.topology = Topology(self.costs + self.evaluators
                                 + self.extra_outputs)
        self.parameters = parameters
        self.optimizer = update_equation
        self.feeding = feeding
        trainable, static, state = parameters.partition()
        self._trainable_names, self._state_names = trainable, state
        self._static_names = static
        self._param_meta = {n: parameters.spec(n).attr
                            for n in trainable + static
                            if parameters.spec(n) is not None}
        values = parameters.as_dict()
        pool = ParamPool({n: values[n] for n in trainable},
                         self._param_meta)
        self._pool = pool if (pool.enabled() and ParamPool.compatible_with(
            update_equation)) else None
        self._pooled = ({e[0] for e in self._pool.entries}
                        if self._pool is not None else set())
        self._materialize_device_state()
        self._opt_state = update_equation.init_state(self._carry(),
                                                     self._param_meta)
        # update hooks prune the initial values too (reference:
        # StaticPruningHook masks at init, not just per update)
        with torch.no_grad():
            for n, attr in self._param_meta.items():
                for hook in getattr(attr, "update_hooks", None) or ():
                    if n in self._trainable:
                        self._trainable[n].copy_(
                            hook.apply(n, self._trainable[n]))
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(flags.get_flag("seed") or 0))
        self._step_count = 0  # global steps, across passes and train calls
        # the fused loop's captured graphs, by (chunk length, feed shape);
        # ``graphs`` describes each: its key, the kernel launches captured
        # in it (by library) and its replays
        self._graphs = {}
        self.graphs = []
        self.chunk_log = []  # the fused loop's chunk sizes, in order
        self._capture_stream = None
        self._capture_lock = None
        # the live AsyncCheckpointer while train(checkpoint_dir=...) runs,
        # and the last session's per-checkpoint readings
        self._ckpt_writer = None
        self.checkpoint_log = []

    # -- device state -------------------------------------------------------
    def _materialize_device_state(self):
        """Stage the Parameters object's values on the device as the
        trainer's float32 masters (pooled ones as views of one flat
        buffer, with their gradients views of one flat gradient buffer),
        its static parameters and its running state."""
        values = {n: v.detach().to(self.device)
                  for n, v in self.parameters.as_dict().items()}
        self._trainable = {}
        if self._pool is not None:
            flat = self._pool.compress(values)[ParamPool.POOL_KEY]
            self._pool_flat = flat
            self._pool_grad = torch.zeros_like(flat)
            for name, off, size, shape in self._pool.entries:
                view = flat[off:off + size].view(shape).requires_grad_()
                view.grad = self._pool_grad[off:off + size].view(shape)
                self._trainable[name] = view
        for n in self._trainable_names:
            if n not in self._trainable:
                self._trainable[n] = (values[n].to(torch.float32).clone()
                                      .requires_grad_())
        self._static = {n: values[n] for n in self._static_names}
        self._state = {n: values[n].to(torch.float32).clone()
                       for n in self._state_names}

    def _carry(self):
        """The masters as the optimizer updates them: the flat pool under
        its key, every other trainable by name."""
        if self._pool is None:
            return self._trainable
        out = {ParamPool.POOL_KEY: self._pool_flat}
        out.update({n: t for n, t in self._trainable.items()
                    if n not in self._pooled})
        return out

    def _carry_grads(self):
        out = {}
        for n, p in self._carry().items():
            if n == ParamPool.POOL_KEY:
                out[n] = self._pool_grad
            else:
                out[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        return out

    def _mutable_tensors(self):
        """Every tensor a train step writes: the masters, the optimizer
        state and the running state."""
        return (_tree_tensors(self._carry()) + _tree_tensors(self._opt_state)
                + list(self._state.values()))

    # -- one step -----------------------------------------------------------
    def _forward(self, feed, mode, state_updates=None):
        """(cost, evaluator stats, extra outputs) of one batch: the cost is
        the sum over the cost layers of their mean per-sample cost
        (paddle_tpu/trainer.py:123)."""
        wanted = ([c.name for c in self.costs]
                  + [e.name for e in self.evaluators]
                  + [o.name for o in self.extra_outputs])
        values = self.topology.apply(
            {**self._trainable, **self._static, **self._state}, feed,
            mode=mode, outputs=wanted, state_updates=state_updates,
            generator=self._generator)
        cost = sum(values[c.name].float().mean() for c in self.costs)
        stats = {e.name: {k: v.detach() for k, v in values[e.name].items()}
                 for e in self.evaluators}
        outs = {o.name: values[o.name] for o in self.extra_outputs}
        return cost, stats, outs

    def _train_step(self, feed):
        """Forward, backward and update of one batch; returns the cost and
        the evaluator stats as device tensors (not read back)."""
        if self._pool is not None:
            self._pool_grad.zero_()
        for n, p in self._trainable.items():
            if n not in self._pooled:
                p.grad = None
        updates = {}
        loss, stats, _ = self._forward(feed, "train", state_updates=updates)
        loss.backward()
        self.optimizer.step(self._carry(), self._carry_grads(),
                            self._opt_state, self._param_meta)
        with torch.no_grad():
            for name, value in updates.items():
                self._state[name].copy_(value)
        return loss.detach(), stats

    def _train_chunk(self, chunk):
        """The K steps of a stacked chunk: length-K device stacks of the
        costs and of each evaluator's stats. On the card one replay of the
        chunk's captured CUDA graph; on the CPU a loop of the same step
        function."""
        if self.device.type == "cuda":
            return self._replay(chunk)
        results = [self._train_step(feed) for feed in chunk.feed]
        return _stack_results(results)

    # -- the fused loop's CUDA graphs ----------------------------------------
    def _replay(self, chunk):
        from paddle_tpu_torch.data.feeder import feed_tensors

        key = (chunk.steps, chunk.key)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(chunk, key)
        # the static slots are written on the step's stream, so a queued
        # replay that still reads them runs before the copy
        for slot, feed in zip(entry["feeds"], chunk.feed):
            for dst, src in zip(feed_tensors(slot), feed_tensors(feed)):
                dst.copy_(src)
        entry["graph"].replay()
        entry["info"]["replays"] += 1
        losses, stats = entry["out"]
        # the next replay overwrites the outputs; finalize reads them a
        # chunk late
        return losses.clone(), _tree_map(torch.clone, stats)

    def _capture(self, chunk, key):
        """Capture the chunk's K train steps as one CUDA graph reading K
        static feed slots. A warm-up step runs first on the capture stream
        (lazy initialisation: the kernel libraries, cuBLAS, autograd's
        device thread) and is undone, so it leaves the trajectory as it
        was. A capture that fails raises; nothing runs eagerly in its
        place."""
        from paddle_tpu_torch.data.feeder import feed_tensors, map_feed

        feeds = [map_feed(f, torch.clone) for f in chunk.feed]
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        t0 = time.perf_counter()
        warm0 = kernel_launch_counts()
        with torch.no_grad():
            saved = [t.clone() for t in self._mutable_tensors()]
        rng = self._generator.get_state()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._train_step(feeds[0])
            with torch.no_grad():
                for t, s in zip(self._mutable_tensors(), saved):
                    t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        draws = not torch.equal(self._generator.get_state(), rng)
        self._generator.set_state(rng)
        del saved
        if draws:
            enforce(register is not None,
                    "steps_per_call: this network draws dropout masks, and "
                    "this torch's CUDAGraph cannot register the trainer's "
                    "generator (no register_generator_state), so replays "
                    "would repeat the captured masks")
        if register is not None:
            register(self._generator)
        before = kernel_launch_counts()
        warmup = {k: before[k] - warm0[k] for k in before
                  if before[k] != warm0[k]}
        lock = self._capture_lock
        try:
            if lock is not None:
                lock.acquire()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = _stack_results([self._train_step(f) for f in feeds])
        except Exception as exc:
            raise RuntimeError(
                "steps_per_call=%d: capturing the fused chunk as a CUDA "
                "graph failed (%s: %s); the fused loop does not run eagerly "
                "in its place" % (chunk.steps, type(exc).__name__, exc)) \
                from exc
        finally:
            if lock is not None:
                lock.release()
        after = kernel_launch_counts()
        info = {"steps": chunk.steps,
                "feed_shapes": [tuple(t.shape)
                                for t in feed_tensors(feeds[0])],
                "captured": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]},
                "warmup": warmup,
                "replays": 0,
                "capture_ms": (time.perf_counter() - t0) * 1e3}
        entry = {"graph": graph, "feeds": feeds, "out": out, "info": info}
        self._graphs[key] = entry
        self.graphs.append(info)
        return entry

    def graph_launches(self):
        """Kernel launches around the captured graphs, by library:
        ``captured`` — the counts the wrappers took while the graphs were
        captured (no kernel ran then); ``warmup`` — the launches of the
        warm-up step before each capture (they ran, and were undone);
        ``replayed`` — each graph's captured launches times its replays
        (the launches that ran inside the graphs)."""
        out = {"captured": {}, "warmup": {}, "replayed": {}}
        for info in self.graphs:
            for name, n in info["captured"].items():
                for key, add in (("captured", n),
                                 ("replayed", n * info["replays"])):
                    out[key][name] = out[key].get(name, 0) + add
            for name, n in info["warmup"].items():
                out["warmup"][name] = out["warmup"].get(name, 0) + n
        return out

    # -- main loop ----------------------------------------------------------
    def train(self, reader, num_passes=1, event_handler=None, feeding=None,
              sync_params=True, test_reader=None, feed_pipeline=False,
              buckets=None, steps_per_call=None, checkpoint_dir=None,
              checkpoint_every=0, checkpoint_keep=3, resume=False,
              checkpoint_sync=False):
        """Event-driven training (v2 SGD.train parity; the options are the
        JAX package's, paddle_tpu/trainer.py:246-320). ``reader`` yields
        minibatches (lists of sample tuples).

        ``buckets``: regroup the minibatch stream by sequence length (True
        derives the boundaries, a list gives them, the dict form
        ``{"boundaries": [...], "drop_remainder": True}`` drops partial
        batches). ``feed_pipeline``: convert and copy batches ahead of the
        step on the DeviceFeeder's producer thread (True = depth 2, or an
        int depth). ``steps_per_call=K``: K steps per chunk of same-shape
        feeds, one captured CUDA graph replay per chunk on the card (the
        feed pipeline is implied and the queue deepened to K); per-step
        events fire K at a time, one chunk late; a one-batch chunk (a
        shape boundary, the pass's last) runs the per-step program.
        ``checkpoint_dir`` + ``checkpoint_every=N``: every N global steps
        (under the fused loop the first chunk boundary at or past it) a
        durable snapshot, overlapped on the ``ckpt-writer`` thread unless
        ``checkpoint_sync``; ``checkpoint_keep`` newest are kept.
        ``resume=True`` restores the newest valid checkpoint in
        ``checkpoint_dir`` and continues the same trajectory: earlier
        passes are skipped, and the resumed pass's trained batches through
        the feeder's cursor. ``num_passes`` stays the total pass count."""
        event_handler = event_handler or default_event_handler
        feeding = feeding or self.feeding
        if buckets is not None and buckets is not False:
            from paddle_tpu_torch.data import bucketing

            opts = dict(buckets) if isinstance(buckets, dict) else {
                "boundaries": None if buckets is True else buckets}
            reader = bucketing.rebucket_batches(
                reader, buckets=opts.get("boundaries"),
                drop_remainder=bool(opts.get("drop_remainder", False)),
                length_of=bucketing.topology_length_of(self.topology,
                                                       feeding))
        k = int(steps_per_call or 0)
        if k:
            enforce(k >= 1, "steps_per_call must be >= 1, got %d", k)
        log_period = flags.get_flag("log_period")
        test_period = flags.get_flag("test_period")
        start_pass = start_cursor = 0
        if checkpoint_dir and resume:
            start_pass, start_cursor = self._resume_restore(checkpoint_dir,
                                                            mode=resume)
        ckpt_ctx = None
        if checkpoint_dir and checkpoint_every:
            ckpt_ctx = self._checkpoint_setup(checkpoint_dir,
                                              checkpoint_every,
                                              checkpoint_keep,
                                              checkpoint_sync)
        loop = dict(event_handler=event_handler, feeding=feeding,
                    sync_params=sync_params, test_reader=test_reader,
                    log_period=log_period, test_period=test_period,
                    start_pass=start_pass, start_cursor=start_cursor,
                    ckpt=ckpt_ctx)
        completed = False
        try:
            if k:
                self._train_passes_fused(
                    reader, num_passes, k,
                    feed_depth=self._feed_depth(feed_pipeline), **loop)
            else:
                self._train_passes(reader, num_passes,
                                   feed_pipeline=feed_pipeline, **loop)
            completed = True
        finally:
            # drain and join the ckpt-writer thread; a writer error
            # surfaces here on a normal exit, and an exception already
            # unwinding stays the one the caller sees
            try:
                if ckpt_ctx is not None:
                    self._checkpoint_close(ckpt_ctx)
            except Exception:
                if completed:
                    raise
                logger.exception("checkpoint writer error during unwind")

    def _finalizer(self, pass_id, eval_acc, event_handler, feeding,
                   test_reader, log_period, test_period):
        """The per-step finalize shared by the loops: merge the step's
        evaluator stats, then EndForwardBackward, the periodic log line
        and test pass, EndIteration with the metrics (TrainerInternal.cpp:
        66-140, one step late)."""

        def finalize(b_id, gstep, cost, stats):
            metrics = {}
            for e in self.evaluators:
                eval_acc[e.name] = e.merge(eval_acc[e.name], stats[e.name])
                metrics[e.name] = e.result(eval_acc[e.name])
            event_handler(v2_event.EndForwardBackward(pass_id, b_id,
                                                      gm=self))
            if log_period and b_id % log_period == 0:
                logger.info("pass %d batch %d cost=%.6f %s", pass_id, b_id,
                            cost, _fmt_metrics(metrics))
            if (test_reader is not None and test_period
                    and gstep % test_period == 0):
                result = self.test(test_reader, feeding=feeding,
                                   pass_id=pass_id)
                logger.info("periodic test: cost=%.6f %s", result.cost,
                            _fmt_metrics(result.metrics))
                event_handler(result)
            event_handler(v2_event.EndIteration(pass_id, b_id, cost,
                                                metrics))

        return finalize

    def _train_passes(self, reader, num_passes, event_handler, feeding,
                      sync_params, test_reader, log_period, test_period,
                      start_pass=0, start_cursor=0, ckpt=None,
                      feed_pipeline=False):
        feeder = None
        for pass_id in range(start_pass, num_passes):
            cursor0 = start_cursor if pass_id == start_pass else 0
            if not feed_pipeline:
                batch_iter = iter(reader())
                for _ in range(cursor0):  # deterministic resume skip
                    if next(batch_iter, None) is None:
                        break
                batch_iter = ((b, None) for b in batch_iter)
            else:
                from paddle_tpu_torch.data.feeder import DeviceFeeder

                if feeder is None:
                    feeder = DeviceFeeder(
                        reader, self.topology, feeding=feeding,
                        depth=self._feed_depth(feed_pipeline),
                        device=self.device)
                batch_iter = ((fb.examples, fb)
                              for fb in feeder.batches(skip=cursor0))
            if cursor0:
                batch_iter = self._resume_pass_iter(batch_iter, pass_id)
                if batch_iter is None:
                    continue  # pass was complete at the checkpoint
            event_handler(v2_event.BeginPass(pass_id))
            eval_acc = {e.name: None for e in self.evaluators}
            finalize = self._finalizer(pass_id, eval_acc, event_handler,
                                       feeding, test_reader, log_period,
                                       test_period)
            batch_id = cursor0
            pass_base = self._step_count - cursor0
            pending = None  # (batch_id, loss, stats)
            for data_batch, fb in batch_iter:
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                if fb is None:
                    # a batch may carry the padded length of its bucket
                    # (``data_batch.bucket``), as in the JAX trainer
                    feed = convert_feed(
                        self.topology, data_batch, self.device, feeding,
                        max_len=getattr(data_batch, "bucket", None))
                else:
                    feed = fb.feed
                loss, stats = self._train_step(feed)
                self._step_count += 1
                self._checkpoint_maybe(ckpt, pass_id, batch_id + 1)
                if pending is not None:
                    self._finalize_one(finalize, pending, pass_base)
                pending = (batch_id, loss, stats)
                batch_id += 1
            if pending is not None:
                self._finalize_one(finalize, pending, pass_base)
            self._finish_pass(pass_id, eval_acc, event_handler, feeding,
                              sync_params, test_reader, test_period)
        if sync_params:
            self._sync_back()

    @staticmethod
    def _finalize_one(finalize, pending, pass_base):
        b_id, loss, stats = pending
        finalize(b_id, pass_base + b_id + 1, float(loss),
                 {name: host_stats(s) for name, s in stats.items()})

    def _finish_pass(self, pass_id, eval_acc, event_handler, feeding,
                     sync_params, test_reader, test_period):
        """Pass-boundary sequence shared by the per-step and fused loops:
        the per-pass test, sync-back, EndPass with the pass metrics."""
        if test_reader is not None and not test_period:
            result = self.test(test_reader, feeding=feeding,
                               pass_id=pass_id)
            logger.info("pass %d test: cost=%.6f %s", pass_id, result.cost,
                        _fmt_metrics(result.metrics))
            event_handler(result)
        if sync_params:
            self._sync_back()
        pass_metrics = {e.name: e.result(eval_acc[e.name])
                        for e in self.evaluators}
        event_handler(v2_event.EndPass(pass_id, pass_metrics, gm=self))

    def _train_passes_fused(self, reader, num_passes, k, event_handler,
                            feeding, sync_params, test_reader, log_period,
                            test_period, feed_depth=2, start_pass=0,
                            start_cursor=0, ckpt=None):
        """The steps_per_call=K loop (paddle_tpu/trainer.py:670-853):
        chunks of K feeds (DeviceFeeder.chunks) through one fused dispatch,
        one chunk deep like the per-step loop — chunk c+1 is dispatched
        before chunk c's length-K cost and stat stacks are read back, and
        its per-step events then fire K at a time."""
        from paddle_tpu_torch.data.feeder import DeviceFeeder

        feeder = DeviceFeeder(reader, self.topology, feeding=feeding,
                              depth=max(int(feed_depth), k),
                              device=self.device)
        self._capture_lock = feeder.lock
        for pass_id in range(start_pass, num_passes):
            # the checkpoint cursor counts batches, so a resume lands
            # exactly even when the chunks regroup
            cursor0 = start_cursor if pass_id == start_pass else 0
            chunk_iter = feeder.chunks(k, skip=cursor0)
            if cursor0:
                chunk_iter = self._resume_pass_iter(chunk_iter, pass_id)
                if chunk_iter is None:
                    continue  # pass was complete at the checkpoint
            event_handler(v2_event.BeginPass(pass_id))
            eval_acc = {e.name: None for e in self.evaluators}
            finalize = self._finalizer(pass_id, eval_acc, event_handler,
                                       feeding, test_reader, log_period,
                                       test_period)
            batch_id = cursor0
            pending = None  # (batch_id, base_step, losses, stats, chunk)

            def finalize_chunk(item):
                b_id, base_step, losses, stats, chunk = item
                costs = np.atleast_1d(losses.float().cpu().numpy()
                                      .astype(np.float64))
                host = {name: host_stats(s) for name, s in stats.items()}
                for i in range(len(costs)):
                    step_stats = {name: ({key: v[i] for key, v in s.items()}
                                         if chunk.stacked else s)
                                  for name, s in host.items()}
                    finalize(b_id + i, base_step + i + 1, float(costs[i]),
                             step_stats)

            for chunk in chunk_iter:
                # every real step of the chunk announces itself before the
                # fused dispatch, so BeginIteration(b) < EndForwardBackward
                # (b) < EndIteration(b) holds for any K
                for i in range(chunk.steps):
                    event_handler(v2_event.BeginIteration(pass_id,
                                                          batch_id + i))
                self.chunk_log.append(chunk.steps)
                if chunk.stacked:
                    losses, stats = self._train_chunk(chunk)
                else:
                    # a one-batch chunk runs the per-step program, as the
                    # JAX package's _stack_chunk does
                    losses, stats = self._train_step(chunk.feed)
                base_step = self._step_count
                self._step_count += chunk.steps
                # chunk boundary == step boundary: the first one at or past
                # the cadence commits the snapshot
                self._checkpoint_maybe(ckpt, pass_id, batch_id + chunk.steps)
                if pending is not None:
                    finalize_chunk(pending)
                pending = (batch_id, base_step, losses, stats, chunk)
                batch_id += chunk.steps
            if pending is not None:
                finalize_chunk(pending)
            self._finish_pass(pass_id, eval_acc, event_handler, feeding,
                              sync_params, test_reader, test_period)
        self._capture_lock = None
        if sync_params:
            self._sync_back()

    @staticmethod
    def _feed_depth(feed_pipeline):
        """Queue depth encoded in train()'s ``feed_pipeline``: an explicit
        int is the depth; True (and off, for the fused loop's implied
        pipeline) the default 2. Booleans first: ``1 == True``."""
        if isinstance(feed_pipeline, bool) or not feed_pipeline:
            return 2
        return max(int(feed_pipeline), 1)

    @staticmethod
    def _resume_pass_iter(batch_iter, pass_id):
        """The resumed pass's stream after the skip, or None when the
        checkpoint cursor sat exactly at the pass boundary (nothing left
        to train; the JAX package's rule, paddle_tpu/trainer.py:871-895)."""
        first = next(batch_iter, None)
        if first is None:
            logger.info("resume: pass %d was already complete at the "
                        "checkpoint; continuing with the next pass",
                        pass_id)
            return None
        return itertools.chain([first], batch_iter)

    def test(self, reader, feeding=None, pass_id=0):
        """One evaluation pass; returns a TestResult event with the
        evaluators' metrics (v2 SGD.test)."""
        feeding = feeding or self.feeding
        eval_acc = {e.name: None for e in self.evaluators}
        total, n_batches = 0.0, 0
        for data_batch in reader():
            feed = convert_feed(self.topology, data_batch, self.device,
                                feeding)
            cost, stats, _ = self._forward(feed, "test")
            total += float(cost)
            n_batches += 1
            for e in self.evaluators:
                eval_acc[e.name] = e.merge(eval_acc[e.name],
                                           host_stats(stats[e.name]))
        metrics = {e.name: e.result(eval_acc[e.name])
                   for e in self.evaluators}
        return v2_event.TestResult(pass_id, total / max(n_batches, 1),
                                   metrics)

    # -- parameters ---------------------------------------------------------
    def _sync_back(self):
        """Copy the trained masters and the running state back into the
        Parameters object (copies: the trainer goes on updating its own in
        place)."""
        self.parameters.update_from(
            {n: t.detach().clone() for n, t in
             {**self._trainable, **self._state}.items()})

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

    # -- checkpoints (paddle_tpu/trainer.py:988-1210) ------------------------
    def _checkpoint_setup(self, directory, every, keep, sync):
        """One checkpoint session per train() call; ``sync=False`` owns an
        AsyncCheckpointer whose writer thread train() closes."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        every = int(every)
        enforce(every >= 1, "checkpoint_every must be >= 1, got %d", every)
        self.checkpoint_log = []
        ctx = {"dir": directory, "every": every, "keep": int(keep),
               "sync": bool(sync),
               "writer": (None if sync else ckpt.AsyncCheckpointer(
                   directory, keep=keep)),
               "next": (self._step_count // every + 1) * every}
        self._ckpt_writer = ctx["writer"]
        return ctx

    def _checkpoint_maybe(self, ctx, pass_id, cursor):
        """Step-boundary cadence check: commit a snapshot whenever the
        global step reached the next multiple of ``checkpoint_every``.
        ``cursor`` = batches consumed within ``pass_id``."""
        if ctx is None or self._step_count < ctx["next"]:
            return
        ctx["next"] = (self._step_count // ctx["every"] + 1) * ctx["every"]
        if ctx["sync"]:
            self._checkpoint_blocking(ctx, pass_id, cursor)
        else:
            self._checkpoint_overlapped(ctx, pass_id, cursor)

    def _checkpoint_overlapped(self, ctx, pass_id, cursor):
        """The step thread's whole share of an overlapped save: a
        device-side clone of the state on the compute stream, the start of
        its copy into pinned host memory on a side stream, and the handoff
        to the ckpt-writer thread (which waits on the copy's event)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        t0 = time.perf_counter()
        with torch.no_grad():
            values = _tree_map(torch.clone, {
                "params": dict(self._trainable), "state": dict(self._state),
                "static": dict(self._static), "opt": self._opt_state})
        event = None
        if self.device.type == "cuda":
            if getattr(self, "_ckpt_stream", None) is None:
                self._ckpt_stream = torch.cuda.Stream(self.device)
            side = self._ckpt_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                host = _tree_map(lambda t: torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True).copy_(
                        t, non_blocking=True), values)
                event = torch.cuda.Event()
                event.record(side)
            for t in _tree_tensors(values):
                t.record_stream(side)  # freed only after the copy read it
        else:
            host = values
        unpool = self._pool.unpool_state if self._pool is not None else None
        ms = (time.perf_counter() - t0) * 1e3
        ctx["writer"].submit(ckpt.CheckpointSnapshot(
            host, self.parameters.copy(), step=self._step_count,
            pass_id=pass_id, pass_cursor=cursor,
            rng=self._generator.get_state(), event=event, unpool=unpool,
            step_thread_ms=ms))
        self.checkpoint_log.append({"step": self._step_count,
                                    "step_thread_ms": ms,
                                    "overlapped": True})

    def _checkpoint_blocking(self, ctx, pass_id, cursor):
        """checkpoint_sync=True: the blocking save on the step thread
        (the public ``save_checkpoint``)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        t0 = time.perf_counter()
        path = self.save_checkpoint(ctx["dir"], pass_id=pass_id,
                                    keep=ctx["keep"],
                                    resume_at=(pass_id, cursor))
        ms = (time.perf_counter() - t0) * 1e3
        self.checkpoint_log.append({"step": self._step_count,
                                    "step_thread_ms": ms,
                                    "bytes": ckpt.checkpoint_bytes(path),
                                    "overlapped": False})

    def _checkpoint_close(self, ctx):
        """Drain and stop the writer; re-raises a writer error so a
        checkpointing run cannot silently lose durability."""
        self._ckpt_writer = None
        writer = ctx["writer"]
        if writer is not None:
            writer.close()
            # a snapshot superseded before the writer started it has no
            # commit, and keeps no bytes
            commits = {c["step"]: c for c in writer.commits}
            for entry in self.checkpoint_log:
                commit = commits.get(entry["step"])
                if commit is not None:
                    entry.update(bytes=commit["bytes"],
                                 writer_ms=commit["writer_ms"])

    def _resume_restore(self, directory, mode=True):
        """Restore the newest valid checkpoint for ``train(resume=...)``;
        returns ``(start_pass, start_cursor)``. ``mode="pass"`` restarts
        the interrupted pass from its first batch."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        if not os.path.isdir(directory):
            logger.info("resume: checkpoint dir %s does not exist yet; "
                        "training from scratch", directory)
            return 0, 0
        meta = self.restore_checkpoint(directory)
        if meta is None:
            logger.info("resume: no valid checkpoint under %s; training "
                        "from scratch", directory)
            return 0, 0
        ts = (meta.get("extra") or {}).get("trainer_state")
        if not ts:
            logger.warning(
                "resume: checkpoint has no trainer_state: weights and "
                "optimizer restored, but the data stream and the generator "
                "restart from pass 0")
            return 0, 0
        own = self._generator.get_state()
        if ts.get("rng_kind") == ckpt.RNG_KIND \
                and len(ts["rng_key"]) == own.numel():
            self._generator.set_state(torch.tensor(ts["rng_key"],
                                                   dtype=torch.uint8))
        else:
            logger.warning(
                "resume: the checkpoint's random key (%s) does not carry "
                "across to this trainer's torch.Generator on %s; dropout "
                "masks continue from the trainer's own seed",
                ts.get("rng_kind", "a JAX threefry key"), self.device)
        start_pass = int(ts["pass"])
        cursor = 0 if mode == "pass" else int(ts["pass_cursor"])
        logger.info("resume: restored step %d (pass %d, batch cursor %d)",
                    self._step_count, start_pass, cursor)
        return start_pass, cursor

    def save_checkpoint(self, directory, pass_id=0, keep=3,
                        coordinator=None, resume_at=None):
        """Durable checkpoint of parameters and optimizer state (the JAX
        package's format). ``resume_at=(pass, cursor)`` embeds the
        trainer_state block a deterministic ``train(resume=True)``
        needs."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        enforce(coordinator is None,
                "save_checkpoint(coordinator=...): the save election is not "
                "ported yet")
        self._sync_back()
        opt_state = _tree_map(ckpt.to_numpy, self._opt_state)
        if self._pool is not None:
            opt_state = self._pool.unpool_state(opt_state)
        extra = None
        if resume_at is not None:
            extra = {"trainer_state": ckpt.trainer_state_meta(
                self._generator.get_state(), resume_at[0], resume_at[1],
                self._step_count)}
        return ckpt.save_checkpoint(
            directory, self.parameters, opt_state=opt_state,
            step=self._step_count, pass_id=pass_id, keep=keep,
            extra_meta=extra)

    def restore_checkpoint(self, directory_or_path):
        """Restore parameters and optimizer state from the newest valid
        checkpoint (written by either package), in place; returns the meta
        dict (or None if nothing found)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        path = directory_or_path
        if os.path.isdir(path) and not os.path.exists(
                os.path.join(path, "meta.json")):
            path = ckpt.latest_checkpoint(path)
            if path is None:
                return None
        params, opt_flat, meta = ckpt.load_checkpoint(path)
        restored, skipped = 0, []
        for name in params.names():
            if name in self.parameters:
                self.parameters.set(name, params.get(name))
                restored += 1
            else:
                skipped.append(name)
        if restored == 0:
            raise ValueError(
                "checkpoint %s shares no parameter names with this model "
                "(checkpoint has %s)" % (path, sorted(params.names())[:8]))
        if skipped:
            logger.warning(
                "restore_checkpoint: %d checkpoint parameter(s) not in "
                "model, skipped: %s", len(skipped), skipped[:8])
        values = self.parameters.as_dict()
        with torch.no_grad():
            for n, t in {**self._trainable, **self._static,
                         **self._state}.items():
                t.copy_(values[n].to(t.device, t.dtype))
            if opt_flat is not None:
                # per-name template (the wire format), then re-pool
                template = _tree_map(ckpt.to_numpy, self.optimizer.init_state(
                    self._trainable, self._param_meta))
                state = ckpt.unflatten_state(template, opt_flat)
                if self._pool is not None:
                    state = self._pool.pool_state(state)
                _copy_into(self._opt_state, state)
        self._step_count = int(meta.get("step", 0))
        return meta


def _stack_results(results):
    """[(loss, stats)] of K steps -> (losses [K], stats with [K] leaves)."""
    losses = torch.stack([loss for loss, _ in results])
    stats = {name: {key: torch.stack([s[name][key] for _, s in results])
                    for key in results[0][1][name]}
             for name in results[0][1]}
    return losses, stats


def default_event_handler(evt):
    pass


def _fmt_metrics(metrics):
    return " ".join("%s=%.5f" % (key, val) for key, val in metrics.items()
                    if isinstance(val, float))
