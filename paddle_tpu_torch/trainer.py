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
(batch norm's moving statistics, written from the ``state_updates`` that
each step's ``Topology.apply`` returns). A captured CUDA graph of a step
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

Telemetry (paddle_tpu/trainer.py:344-470): host spans around every phase
(``feed``, ``train_step``, ``train_chunk``, ``eval_readback``,
``test_feed``, ``test_step``, ``checkpoint_snapshot``,
``checkpoint_sync``) feed the global StatSet, dumped and reset at every
EndPass under the ``stats`` flag; under ``PADDLE_TPU_TORCH_TELEMETRY``
(or the ``telemetry`` flag) a JSONL step log with the JAX package's
schema (observe/steplog.py) and, at the end of the run, a Chrome trace of
the spans. The four training metrics, the per-worker health history and
the loss sentinel with its flight recorder (``PADDLE_TPU_TORCH_SENTINEL``)
run on every finalize. All of it reads what finalize already read back:
no step gains a synchronize, and nothing of it runs inside a captured
graph. The ``trap_fpe`` flag makes each step compute one finiteness flag
per tensor it produced (the cost, each gradient, each updated master) on
the device, read at finalize with the cost: FloatingPointError names the
first step and tensor that held a NaN or an Inf (one chunk late under
``steps_per_call``, as the sentinel). ``show_layer_stat`` and
``show_parameter_stats_period`` log the JAX package's lines.

The trainer runs on ``device`` (the card unless ``device="cpu"``; it
raises without a card).

Data parallelism (``parallelism=DataParallel(...)``, parallel/mesh.py): the
trainer is built in every rank of a torch.distributed process group
(distributed/multihost.py), and rank 0's parameters are broadcast to the
others. Every rank reads the same global batch and trains its contiguous
share of the rows (``DataParallel.shard_batch``). A step weights the
rank's mean cost by its share of the global rows and sums the gradients
with ``all_reduce`` (the flat pool gradient in one call, then each other
gradient), so every rank applies the single-process update; the reported
cost is the all-reduced global mean. The additive evaluator statistics
(those merged by summing) are all-reduced in the step; the others are
gathered at finalize and merged rank by rank. Train-mode batch norm
reduces its moments over the global batch (ops/conv.py). Under NCCL the
collectives are captured in the fused loop's CUDA graphs; gloo cannot be
captured on CUDA tensors, so ``steps_per_call`` is refused there. The test
pass is not split: every rank evaluates the whole test reader.
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
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import sentinel as observe_sentinel
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.observe import steplog as observe_steplog
from paddle_tpu_torch.observe import trainview as observe_trainview
from paddle_tpu_torch.optimizer import Optimizer, ParamPool
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger
from paddle_tpu_torch.utils.stat import global_stats


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


def _map_sharded(tree, names, fn, name=None):
    """``tree`` (the trainer's values or its per-name optimizer state)
    with ``fn(name, leaf)`` applied to every leaf kept under a name in
    ``names`` (a sharded parameter: its value, and each slot, per-row
    step or average under its name)."""
    if isinstance(tree, dict):
        return {k: _map_sharded(v, names, fn, k if k in names else name)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_map_sharded(v, names, fn, name) for v in tree)
    if name is None or not hasattr(tree, "shape"):
        return tree
    return fn(name, tree)


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
        from paddle_tpu_torch.parallel.mesh import DataParallel

        enforce(parallelism is None or isinstance(parallelism, DataParallel),
                "SGD(parallelism=%r): data parallelism takes a "
                "paddle_tpu_torch.parallel.DataParallel", parallelism)
        extra = ([extra_layers] if isinstance(extra_layers, LayerNode)
                 else list(extra_layers or []))
        enforce(all(isinstance(e, LayerNode) for e in extra),
                "SGD(extra_layers=...) takes layers (evaluators or extra "
                "outputs), got %r", extra)
        self.device = resolve_device(device)
        self.parallelism = parallelism
        if parallelism is not None:
            parallelism.check_device(self.device)
        from paddle_tpu_torch.multi_network import MultiNetwork

        if isinstance(cost, MultiNetwork):
            # the joint cost: sum_i w_i * mean(cost_i)
            self.costs = list(cost.costs)
            self._cost_weights = list(cost.weights)
        else:
            self.costs = [cost] if isinstance(cost, LayerNode) else list(cost)
            self._cost_weights = [1.0] * len(self.costs)
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
        # a sharded parameter (each rank its own block) stays out of the
        # flat pool, whose buffer every rank of the world shares
        self._sharded = {n: parameters.spec(n).sharding
                         for n in trainable + static + state
                         if getattr(parameters.spec(n), "sharding", None)
                         is not None}
        pool = ParamPool({n: values[n] for n in trainable
                          if n not in self._sharded}, self._param_meta)
        self._pool = pool if (pool.enabled() and ParamPool.compatible_with(
            update_equation)) else None
        self._pooled = ({e[0] for e in self._pool.entries}
                        if self._pool is not None else set())
        self._materialize_device_state()
        if parallelism is not None:
            # every rank starts from rank 0's values; a sharded parameter's
            # block from the first rank of its data-axis slice
            held = (list(self._carry().items())
                    + list(self._static.items()) + list(self._state.items()))
            for sharded in (False, True):
                parallelism.broadcast_(
                    [t for n, t in held if (n in self._sharded) == sharded],
                    sharded=sharded)
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
        self._trap = False  # the trap_fpe flag of the running train()
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
    def _forward(self, feed, mode):
        """(cost, evaluator stats, extra outputs, running-state updates) of
        one batch: the cost is the weighted sum over the cost layers of
        their mean per-sample cost (paddle_tpu/trainer.py:123; each weight
        1 but under a MultiNetwork's joint cost)."""
        wanted = ([c.name for c in self.costs]
                  + [e.name for e in self.evaluators]
                  + [o.name for o in self.extra_outputs])
        values, updates = self.topology.apply(
            {**self._trainable, **self._static, **self._state}, feed,
            mode=mode, rng=self._generator, outputs=wanted)
        cost = sum(w * values[c.name].float().mean()
                   for c, w in zip(self.costs, self._cost_weights))
        stats = {e.name: {k: v.detach() for k, v in values[e.name].items()}
                 for e in self.evaluators}
        outs = {o.name: values[o.name] for o in self.extra_outputs}
        return cost, stats, outs, updates

    def _train_step(self, feed, share=None):
        """Forward, backward and update of one batch; returns the cost, the
        evaluator stats and, under ``trap_fpe``, the finiteness flags
        (else None), as device tensors (not read back). Under data
        parallelism ``feed`` is this rank's share of the global batch and
        ``share`` its ``(rows, global rows)``."""
        if self._pool is not None:
            self._pool_grad.zero_()
        for n, p in self._trainable.items():
            if n not in self._pooled:
                p.grad = None
        if self.parallelism is None:
            loss, stats, _, updates = self._forward(feed, "train")
            loss.backward()
        else:
            loss, stats, updates = self._dp_forward_backward(feed, share)
        self.optimizer.step(self._carry(), self._carry_grads(),
                            self._opt_state, self._param_meta)
        with torch.no_grad():
            for name, value in updates.items():
                self._state[name].copy_(value)
            finite = self._finite_flags(loss) if self._trap else None
        return loss.detach(), stats, finite

    def _dp_forward_backward(self, feed, share):
        """The data-parallel forward and backward: the rank's mean cost
        weighted by its share of the global rows, the gradients summed
        over the ranks (the flat pool gradient first, then every other
        gradient in the trainables' order), and the global cost and the
        additive evaluator statistics summed the same way. A rank with an
        empty share ran on one borrowed row, and counts nothing."""
        from paddle_tpu_torch.evaluator import _acc_add

        dp = self.parallelism
        rows, total = share
        weight = rows / total
        with dp.batch_scope(rows > 0):
            loss, stats, _, updates = self._forward(feed, "train")
            (loss * weight).backward()
        grads = [self._pool_grad] if self._pool is not None else []
        for n, p in self._trainable.items():
            if n not in self._pooled:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        for g in grads:
            dp.all_reduce_(g)
        loss = dp.all_reduce_(loss.detach() * weight)
        for e in self.evaluators:
            if e.merge is _acc_add:
                stats[e.name] = {
                    k: dp.all_reduce_(v.clone() if rows
                                      else torch.zeros_like(v))
                    for k, v in stats[e.name].items()}
        return loss, stats, updates

    def _gathered_stats(self, host, share):
        """Finalize's host stats with each non-additive evaluator's
        replaced by every live rank's (:class:`_RankStats`), under data
        parallelism; as they are otherwise."""
        from paddle_tpu_torch.evaluator import _acc_add

        names = [e.name for e in self.evaluators if e.merge is not _acc_add]
        if self.parallelism is None or not names:
            return host
        mine = {n: host[n] for n in names} if share[0] else None
        got = [g for g in self.parallelism.gather(mine) if g is not None]
        return dict(host, **{n: _RankStats([g[n] for g in got])
                             for n in names})

    def _finite_flags(self, loss):
        """One bool per tensor the step produced, in the order of
        ``_fpe_names``: the cost, each gradient, each updated master."""
        names = list(self._trainable)
        flags_ = [torch.isfinite(loss).all()]
        for n in names:
            grad = self._trainable[n].grad
            flags_.append(torch.isfinite(grad).all() if grad is not None
                          else torch.ones((), dtype=torch.bool,
                                          device=loss.device))
        flags_ += [torch.isfinite(self._trainable[n]).all() for n in names]
        return torch.stack(flags_)

    def _fpe_names(self):
        names = list(self._trainable)
        return (["the cost"] + ["the gradient of %s" % n for n in names]
                + ["the updated parameter %s" % n for n in names])

    def _train_chunk(self, chunk):
        """The K steps of a stacked chunk: length-K device stacks of the
        costs, of each evaluator's stats and of the finiteness flags. On
        the card one replay of the chunk's captured CUDA graph; on the CPU
        a loop of the same step function."""
        if self.device.type == "cuda":
            return self._replay(chunk)
        results = [self._train_step(feed, fb.share)
                   for feed, fb in zip(chunk.feed, chunk.batches)]
        return _stack_results(results)

    # -- the fused loop's CUDA graphs ----------------------------------------
    def _replay(self, chunk):
        from paddle_tpu_torch.data.feeder import feed_tensors

        key = (chunk.steps, chunk.key, self._trap)
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
        # the next replay overwrites the outputs; finalize reads them a
        # chunk late
        return _tree_map(torch.clone, entry["out"])

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
        share = chunk.batches[0].share
        with torch.cuda.stream(stream):
            self._train_step(feeds[0], share)
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
                out = _stack_results([self._train_step(f, share)
                                      for f in feeds])
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
        observe_steplog.emit_event("/paddle_tpu_torch/cuda_graph_capture",
                                   info["capture_ms"] / 1e3)
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
            enforce(self.parallelism is None
                    or self.parallelism.capturable(self.device),
                    "steps_per_call=%d: the %s process group stages CUDA "
                    "tensors through the host, which a CUDA graph cannot "
                    "capture; the fused loop does not run eagerly in its "
                    "place (NCCL, one card a rank, captures it)", k,
                    self.parallelism and self.parallelism.backend)
        log_period = flags.get_flag("log_period")
        test_period = flags.get_flag("test_period")
        self._trap = bool(flags.get_flag("trap_fpe"))
        tele = _Telemetry(self, num_passes, k)
        start_pass = start_cursor = 0
        if checkpoint_dir and resume:
            start_pass, start_cursor = self._resume_restore(checkpoint_dir,
                                                            mode=resume)
        ckpt_ctx = None
        if checkpoint_dir and checkpoint_every:
            ckpt_ctx = self._checkpoint_setup(checkpoint_dir,
                                              checkpoint_every,
                                              checkpoint_keep,
                                              checkpoint_sync, tele)
        loop = dict(event_handler=event_handler, feeding=feeding,
                    sync_params=sync_params, test_reader=test_reader,
                    log_period=log_period, test_period=test_period,
                    start_pass=start_pass, start_cursor=start_cursor,
                    ckpt=ckpt_ctx, tele=tele)
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
        except BaseException as exc:
            # any escape from the loop dumps the black box (a sentinel
            # halt already did; on_exception skips it)
            tele.on_exception(exc)
            if ckpt_ctx is not None and ckpt_ctx["writer"] is not None:
                from paddle_tpu_torch.distributed.elastic import (
                    SelfLeaseLost, WorkerLost)

                if isinstance(exc, (WorkerLost, SelfLeaseLost)):
                    # a reform abort: each worker stops at its OWN step
                    # boundary, so committing the pending snapshot here
                    # would move the shared directory's rewind target
                    # differently per worker (and a self-lapsed worker's
                    # snapshot is of the abandoned pre-reform branch)
                    ckpt_ctx["writer"].discard_pending()
            raise
        finally:
            # drain and join the ckpt-writer thread; a writer error
            # surfaces here on a normal exit, and an exception already
            # unwinding stays the one the caller sees
            try:
                if ckpt_ctx is not None:
                    self._checkpoint_close(ckpt_ctx, completed)
            except Exception:
                if completed:
                    raise
                logger.exception("checkpoint writer error during unwind")
            finally:
                tele.close()

    def _finalizer(self, pass_id, eval_acc, event_handler, feeding,
                   test_reader, log_period, test_period, tele):
        """The per-step finalize shared by the loops: the trap_fpe check,
        the evaluators' merge, the step's telemetry (steplog record,
        metrics, health history, sentinel), then EndForwardBackward, the
        periodic log line (with the layer and parameter stats) and test
        pass, EndIteration with the metrics (TrainerInternal.cpp:66-140,
        one step late). ``wall_ms`` is the interval since the last
        finalize; inside a fused chunk it is None (the interval is the
        chunk's) and ``chunk_index`` is the step's place in the chunk."""
        fpe_names = self._fpe_names() if self._trap else None

        def finalize(b_id, gstep, cost, stats, examples, feed, feed_ms=None,
                     wall_ms=None, finite=None, chunk_index=None):
            if finite is not None and not finite.all():
                raise FloatingPointError(
                    "trap_fpe: step %d (pass %d, batch %d): %s holds a NaN "
                    "or an Inf" % (gstep, pass_id, b_id,
                                   fpe_names[int(np.argmin(finite))]))
            metrics = {}
            for e in self.evaluators:
                for s in (stats[e.name] if isinstance(stats[e.name],
                                                      _RankStats)
                          else (stats[e.name],)):
                    eval_acc[e.name] = e.merge(eval_acc[e.name], s)
                metrics[e.name] = e.result(eval_acc[e.name])
            tele.step(gstep, pass_id, b_id, cost, examples, metrics,
                      feed_ms, wall_ms, chunk_index)
            event_handler(v2_event.EndForwardBackward(pass_id, b_id,
                                                      gm=self))
            if log_period and b_id % log_period == 0:
                logger.info("pass %d batch %d cost=%.6f %s", pass_id, b_id,
                            cost, _fmt_metrics(metrics))
                if flags.get_flag("show_layer_stat"):
                    self._log_layer_stats(feed)
            psp = flags.get_flag("show_parameter_stats_period")
            if psp and gstep % max(psp, 1) == 0:
                self._log_param_stats()
            if (test_reader is not None and test_period
                    and gstep % test_period == 0):
                result = self.test(test_reader, feeding=feeding,
                                   pass_id=pass_id)
                logger.info("periodic test: cost=%.6f %s", result.cost,
                            _fmt_metrics(result.metrics))
                event_handler(result)
                # the test pass is not charged to the next interval
                tele.reset_clock()
            event_handler(v2_event.EndIteration(pass_id, b_id, cost,
                                                metrics))

        return finalize

    def _train_passes(self, reader, num_passes, event_handler, feeding,
                      sync_params, test_reader, log_period, test_period,
                      tele, start_pass=0, start_cursor=0, ckpt=None,
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
                        parallelism=self.parallelism, device=self.device)
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
                                       test_period, tele)
            batch_id = cursor0
            pass_base = self._step_count - cursor0
            pending = None
            for data_batch, fb in batch_iter:
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                if fb is None:
                    # a batch may carry the padded length of its bucket
                    # (``data_batch.bucket``), as in the JAX trainer
                    with observe_spans.span("feed") as feed_scope:
                        feed, share = self._convert(data_batch, feeding)
                    feed_ms, n_examples = feed_scope.dur * 1e3, \
                        len(data_batch)
                else:
                    # the pipelined feed's "feed" span and feed_ms are the
                    # step thread's stall on the queue
                    feed, feed_ms, n_examples, share = fb.feed, \
                        fb.stall_ms, fb.examples, fb.share
                with observe_spans.span("train_step"):
                    loss, stats, finite = self._train_step(feed, share)
                self._step_count += 1
                self._checkpoint_maybe(ckpt, pass_id, batch_id + 1)
                if fb is not None:
                    tele.feed(self._step_count, fb, feeder.depth)
                if pending is not None:
                    self._finalize_one(finalize, pending, pass_base, tele)
                pending = (batch_id, loss, stats, finite, feed, feed_ms,
                           n_examples, share)
                batch_id += 1
            if pending is not None:
                self._finalize_one(finalize, pending, pass_base, tele)
            self._finish_pass(pass_id, eval_acc, event_handler, feeding,
                              sync_params, test_reader, test_period, tele)
        if sync_params:
            self._sync_back()

    def _convert(self, data_batch, feeding):
        """The synchronous feed of one minibatch on the trainer's device
        (a batch may carry the padded length of its bucket,
        ``data_batch.bucket``, as in the JAX trainer), and under data
        parallelism this rank's share of it: ``(feed, share)``."""
        max_len = getattr(data_batch, "bucket", None)
        if self.parallelism is None:
            return convert_feed(self.topology, data_batch, feeding,
                                max_len=max_len, device=self.device), None
        host = convert_feed(self.topology, data_batch, feeding,
                            max_len=max_len, device="cpu")
        return self.parallelism.shard_batch(host, device=self.device)

    def _finalize_one(self, finalize, pending, pass_base, tele):
        b_id, loss, stats, finite, feed, feed_ms, n_examples, share = pending
        with observe_spans.span("eval_readback"):
            cost = float(loss)
            host = self._gathered_stats(
                {name: host_stats(s) for name, s in stats.items()}, share)
            if finite is not None:
                finite = finite.cpu().numpy()
        finalize(b_id, pass_base + b_id + 1, cost, host, n_examples, feed,
                 feed_ms=feed_ms, wall_ms=tele.lap(), finite=finite)

    def _finish_pass(self, pass_id, eval_acc, event_handler, feeding,
                     sync_params, test_reader, test_period, tele):
        """Pass-boundary sequence shared by the per-step and fused loops:
        the per-pass test, sync-back, the pass record, the StatSet dump
        under the ``stats`` flag, EndPass with the pass metrics."""
        if test_reader is not None and not test_period:
            result = self.test(test_reader, feeding=feeding,
                               pass_id=pass_id)
            logger.info("pass %d test: cost=%.6f %s", pass_id, result.cost,
                        _fmt_metrics(result.metrics))
            event_handler(result)
            tele.reset_clock()
        if sync_params:
            self._sync_back()
        pass_metrics = {e.name: e.result(eval_acc[e.name])
                        for e in self.evaluators}
        if tele.slog is not None:
            tele.slog.log_pass(pass_id, metrics=pass_metrics)
        if observe_steplog.stats_enabled():
            # the reference's per-pass timer dump and reset
            # (globalStat.printAllStatus at FinishTrainPass)
            global_stats.print_all()
            global_stats.reset()
        event_handler(v2_event.EndPass(pass_id, pass_metrics, gm=self))
        # pass-boundary work (EndPass handlers, a save) is not charged to
        # the next pass's first step
        tele.reset_clock()

    def _train_passes_fused(self, reader, num_passes, k, event_handler,
                            feeding, sync_params, test_reader, log_period,
                            test_period, tele, feed_depth=2, start_pass=0,
                            start_cursor=0, ckpt=None):
        """The steps_per_call=K loop (paddle_tpu/trainer.py:670-853):
        chunks of K feeds (DeviceFeeder.chunks) through one fused dispatch,
        one chunk deep like the per-step loop — chunk c+1 is dispatched
        before chunk c's length-K cost, stat and flag stacks are read back,
        and its per-step events then fire K at a time. The chunk's wall
        interval lands on its ``train_chunk`` record; its ``step`` records
        carry none."""
        from paddle_tpu_torch.data.feeder import DeviceFeeder

        feeder = DeviceFeeder(reader, self.topology, feeding=feeding,
                              depth=max(int(feed_depth), k),
                              parallelism=self.parallelism,
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
                                       test_period, tele)
            batch_id = cursor0
            pending = None  # (batch_id, base_step, (losses, stats, finite),
            #                  chunk)

            def finalize_chunk(item):
                b_id, base_step, (losses, stats, finite), chunk = item
                with observe_spans.span("eval_readback"):
                    costs = np.atleast_1d(losses.float().cpu().numpy()
                                          .astype(np.float64))
                    host = self._gathered_stats(
                        {name: host_stats(s) for name, s in stats.items()},
                        chunk.batches[0].share)
                    if finite is not None:
                        finite = np.atleast_2d(finite.cpu().numpy())
                tele.chunk(base_step, pass_id, b_id, costs, chunk)
                for i in range(len(costs)):
                    step_stats = {name: _step_of(s, i, chunk.stacked)
                                  for name, s in host.items()}
                    fb = chunk.batches[i]
                    finalize(b_id + i, base_step + i + 1, float(costs[i]),
                             step_stats, fb.examples, fb.feed,
                             finite=None if finite is None else finite[i],
                             chunk_index=i)

            for chunk in chunk_iter:
                # every real step of the chunk announces itself before the
                # fused dispatch, so BeginIteration(b) < EndForwardBackward
                # (b) < EndIteration(b) holds for any K
                for i in range(chunk.steps):
                    event_handler(v2_event.BeginIteration(pass_id,
                                                          batch_id + i))
                self.chunk_log.append(chunk.steps)
                with observe_spans.span("train_chunk",
                                        args={"steps": chunk.steps}):
                    if chunk.stacked:
                        out = self._train_chunk(chunk)
                    else:
                        # a one-batch chunk runs the per-step program, as
                        # the JAX package's _stack_chunk does
                        out = self._train_step(chunk.feed,
                                               chunk.batches[0].share)
                base_step = self._step_count
                self._step_count += chunk.steps
                # chunk boundary == step boundary: the first one at or past
                # the cadence commits the snapshot
                self._checkpoint_maybe(ckpt, pass_id, batch_id + chunk.steps)
                for i, fb in enumerate(chunk.batches):
                    tele.feed(base_step + i + 1, fb, feeder.depth)
                if pending is not None:
                    finalize_chunk(pending)
                pending = (batch_id, base_step, out, chunk)
                batch_id += chunk.steps
            if pending is not None:
                finalize_chunk(pending)
            self._finish_pass(pass_id, eval_acc, event_handler, feeding,
                              sync_params, test_reader, test_period, tele)
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
            with observe_spans.span("test_feed"):
                feed = convert_feed(self.topology, data_batch, feeding,
                                    device=self.device)
            with observe_spans.span("test_step"):
                cost, stats, _, _ = self._forward(feed, "test")
            with observe_spans.span("eval_readback"):
                total += float(cost)
                n_batches += 1
                for e in self.evaluators:
                    eval_acc[e.name] = e.merge(eval_acc[e.name],
                                               host_stats(stats[e.name]))
        metrics = {e.name: e.result(eval_acc[e.name])
                   for e in self.evaluators}
        return v2_event.TestResult(pass_id, total / max(n_batches, 1),
                                   metrics)

    # -- the stats flags (Flags.cpp:71 --show_layer_stat;
    # TrainerInternal.cpp:100-110 --show_param_stats_period) ----------------
    def _log_layer_stats(self, feed):
        """Per-layer output mean/|mean|/max from a plain forward on the
        batch, in the JAX package's line format."""
        from paddle_tpu_torch.layer.base import data_of

        values, _ = self.topology.apply_all(
            {**self._trainable, **self._static, **self._state}, feed,
            mode="test")
        for name, val in values.items():
            val = data_of(val)
            if not (isinstance(val, torch.Tensor)
                    and (val.is_floating_point() or val.is_complex())):
                continue
            arr = val.detach().float().cpu().numpy()
            logger.info("layer %s: avg=%.6g absavg=%.6g max=%.6g", name,
                        arr.mean(), np.abs(arr).mean(), arr.max())

    def _log_param_stats(self):
        for name, val in self._trainable.items():
            arr = val.detach().float().cpu().numpy()
            logger.info("param %s: avg_abs=%.6g max_abs=%.6g", name,
                        np.abs(arr).mean(), np.abs(arr).max())

    # -- parameters ---------------------------------------------------------
    def _sync_back(self):
        """Copy the trained masters and the running state back into the
        Parameters object (copies: the trainer goes on updating its own in
        place)."""
        self.parameters.update_from(
            {n: t.detach().clone() for n, t in
             {**self._trainable, **self._state}.items()})

    def stage_parameters(self):
        """Copy the Parameters object's values into the trainer's tensors
        on the device, in place (after ``parameters.init_from_tar`` or
        ``set``; the JAX trainer's ``__prepare__``). The optimizer state
        is left as it is."""
        values = self.parameters.as_dict()
        with torch.no_grad():
            for n, t in {**self._trainable, **self._static,
                         **self._state}.items():
                t.copy_(values[n].to(t.device, t.dtype))

    def save_parameter_to_tar(self, f):
        self._sync_back()
        self.parameters.to_tar(f)

    def export_inference_bundle(self, output_layer, out_dir, **export_kw):
        """Sync the trained parameters back and export the inference
        forward over ``output_layer`` as a serving bundle
        (paddle_tpu/trainer.py ``export_inference_bundle``;
        serve/export.py export_bundle kwargs pass through). The programs
        take the trainer's whole parameter set, as the JAX package's do,
        and serve on the trainer's device type unless ``platforms`` says
        otherwise. The train -> export -> serve demo path:
        demos/fit_a_line/train.py."""
        from paddle_tpu_torch.serve.export import export_bundle

        self._sync_back()
        export_kw.setdefault("platforms", (self.device.type,))
        return export_bundle(output_layer, self.parameters, out_dir,
                             **export_kw)

    # -- checkpoints (paddle_tpu/trainer.py:988-1210) ------------------------
    def _checkpoint_setup(self, directory, every, keep, sync, tele):
        """One checkpoint session per train() call; ``sync=False`` owns an
        AsyncCheckpointer whose writer thread train() closes (and which
        writes the commits into the run's steplog)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        every = int(every)
        enforce(every >= 1, "checkpoint_every must be >= 1, got %d", every)
        self.checkpoint_log = []
        ctx = {"dir": directory, "every": every, "keep": int(keep),
               "sync": bool(sync), "tele": tele,
               "writer": (None if sync else ckpt.AsyncCheckpointer(
                   directory, keep=keep, steplog=tele.slog)),
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
        device-side clone of the state on the compute stream (a sharded
        parameter's gathered there, so the writer thread makes no
        collective), the start of its copy into pinned host memory on a
        side stream, and the handoff to the ckpt-writer thread (which
        waits on the copy's event)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        t0 = time.perf_counter()
        with observe_spans.span("checkpoint_snapshot",
                                args={"step": self._step_count}):
            with torch.no_grad():
                values = _tree_map(torch.clone, self._gather_sharded({
                    "params": dict(self._trainable),
                    "state": dict(self._state),
                    "static": dict(self._static), "opt": self._opt_state}))
            if not self._writes_checkpoints():
                self.checkpoint_log.append({
                    "step": self._step_count, "overlapped": True,
                    "step_thread_ms": (time.perf_counter() - t0) * 1e3})
                return
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
                    t.record_stream(side)  # freed after the copy read it
            else:
                host = values
        unpool = self._pool.unpool_state if self._pool is not None else None
        ms = (time.perf_counter() - t0) * 1e3
        observe_trainview.get_train_history().record_checkpoint(ms)
        template = (Parameters(None, self._global_specs()) if self._sharded
                    else self.parameters.copy())
        ctx["writer"].submit(ckpt.CheckpointSnapshot(
            host, template, step=self._step_count,
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
        with observe_spans.span("checkpoint_sync",
                                args={"step": self._step_count}):
            path = self.save_checkpoint(ctx["dir"], pass_id=pass_id,
                                        keep=ctx["keep"],
                                        resume_at=(pass_id, cursor))
        ms = (time.perf_counter() - t0) * 1e3
        observe_trainview.get_train_history().record_checkpoint(ms)
        if path is None:   # another rank writes the sharded model's state
            self.checkpoint_log.append({"step": self._step_count,
                                        "step_thread_ms": ms,
                                        "overlapped": False})
            return
        nbytes = ckpt.checkpoint_bytes(path)
        self.checkpoint_log.append({"step": self._step_count,
                                    "step_thread_ms": ms, "bytes": nbytes,
                                    "overlapped": False})
        if ctx["tele"].slog is not None:
            ckpt.log_commit(ctx["tele"].slog, self._step_count, ms, nbytes,
                            False, ms, pass_id, path)

    def _checkpoint_close(self, ctx, completed=False):
        """Drain and stop the writer; re-raises a writer error so a
        checkpointing run cannot silently lose durability. After a run
        that ``completed``, a sharded model's ranks wait for rank 0's
        commits, so none leaves train() before a resume can read them."""
        self._ckpt_writer = None
        writer = ctx["writer"]
        try:
            if writer is not None:
                writer.close()
                # a snapshot superseded before the writer started it has
                # no commit, and keeps no bytes
                commits = {c["step"]: c for c in writer.commits}
                for entry in self.checkpoint_log:
                    commit = commits.get(entry["step"])
                    if commit is not None:
                        entry.update(bytes=commit["bytes"],
                                     writer_ms=commit["writer_ms"])
        finally:
            from paddle_tpu_torch.parallel.mesh import world_size

            if completed and self._sharded and world_size() > 1:
                import torch.distributed as dist

                dist.barrier()

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
        package's format). With a ``coordinator`` client
        (distributed/client.py) the trainer takes part in the save
        election, so exactly one worker writes (reference
        RequestSaveModel); a loser returns None. Every rank of a model
        with sharded parameters calls it without a ``coordinator``: each
        gathers its blocks, rank 0 writes and the others return None.
        ``resume_at=(pass, cursor)`` embeds the trainer_state block a
        deterministic ``train(resume=True)`` needs."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        enforce(coordinator is None or not self._sharded,
                "save_checkpoint(coordinator=) elects one writer, but "
                "gathering the sharded parameters %s needs every rank: "
                "save without coordinator= (rank 0 writes)",
                sorted(self._sharded))
        if coordinator is not None and not coordinator.request_save_model():
            return None
        self._sync_back()
        with torch.no_grad():
            opt_state = self._gather_sharded(self._opt_state)
        parameters = self.parameters
        if self._sharded:
            parameters = Parameters(
                self._gather_sharded(parameters.as_dict()),
                self._global_specs())
        if not self._writes_checkpoints():
            return None
        opt_state = _tree_map(ckpt.to_numpy, opt_state)
        if self._pool is not None:
            opt_state = self._pool.unpool_state(opt_state)
        extra = None
        if resume_at is not None:
            extra = {"trainer_state": ckpt.trainer_state_meta(
                self._generator.get_state(), resume_at[0], resume_at[1],
                self._step_count)}
        return ckpt.save_checkpoint(
            directory, parameters, opt_state=opt_state,
            step=self._step_count, pass_id=pass_id, keep=keep,
            extra_meta=extra)

    # -- sharded parameters in a checkpoint ----------------------------------
    # A checkpoint holds global values (the JAX package's format). Every
    # rank gathers its sharded blocks and their optimizer entries on the
    # step thread, a collective over the sharding's axes, and rank 0 of
    # the world writes (the others hold the same global values); a
    # restore cuts each rank's block again.
    def _leaf_sharding(self, name, ndim):
        """The sharding of a leaf of ``ndim`` dimensions kept for sharded
        parameter ``name`` and the global shape it has: the parameter's
        own for a leaf of its rank, that of its leading dimensions for a
        per-row one (None for a scalar)."""
        shape = self.parameters.spec(name).shape
        if ndim == 0 or ndim > len(shape):
            return None, None
        return self._sharded[name].leading(ndim), shape[:ndim]

    def _gather_sharded(self, tree):
        """``tree`` with every block of a sharded parameter and of its
        optimizer entries gathered to the global tensor."""
        def gather(name, block):
            sharding, shape = self._leaf_sharding(name, block.dim())
            if sharding is None or \
                    tuple(block.shape) != sharding.local_shape(shape):
                return block
            return sharding.gather(block)

        return _map_sharded(tree, self._sharded, gather)

    def _block_sharded(self, tree):
        """``tree`` (numpy or tensor leaves) with every global tensor of a
        sharded parameter's entries cut to this rank's block."""
        def cut(name, value):
            value = torch.as_tensor(np.asarray(value))
            sharding, shape = self._leaf_sharding(name, value.dim())
            if sharding is None or tuple(value.shape) != shape:
                return value
            return sharding.block(value, shape)

        return _map_sharded(tree, self._sharded, cut)

    def _global_specs(self):
        """The parameters' specs without their sharding (a checkpoint's
        values are global)."""
        from paddle_tpu_torch.graph import ParamSpec

        specs = {}
        for name in self.parameters.names():
            spec = self.parameters.spec(name)
            if name in self._sharded:
                spec = ParamSpec(spec.name, spec.shape, spec.initializer,
                                 spec.attr, spec.is_state)
            specs[name] = spec
        return specs

    def _writes_checkpoints(self):
        """Whether this rank writes: every rank of an unsharded model (each
        holds the whole state), rank 0 alone of a sharded one."""
        from paddle_tpu_torch.parallel.mesh import rank

        return not self._sharded or rank() == 0

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
        self.stage_parameters()
        with torch.no_grad():
            if opt_flat is not None:
                # per-name template (the wire format), then re-pool
                template = _tree_map(ckpt.to_numpy, self.optimizer.init_state(
                    self._trainable, self._param_meta))
                state = self._block_sharded(
                    ckpt.unflatten_state(template, opt_flat))
                if self._pool is not None:
                    state = self._pool.pool_state(state)
                _copy_into(self._opt_state, state)
        self._step_count = int(meta.get("step", 0))
        return meta


class _RankStats(list):
    """One evaluator's host stats of a step from every live rank, in rank
    order (a non-additive evaluator under data parallelism), merged one
    after the other."""


def _step_of(stats, i, stacked):
    """Step ``i``'s stats of a fused chunk's stacked host stats."""
    if isinstance(stats, _RankStats):
        return _RankStats(_step_of(s, i, stacked) for s in stats)
    return {key: v[i] for key, v in stats.items()} if stacked else stats


def _stack_results(results):
    """[(loss, stats, finite)] of K steps -> (losses [K], stats with [K]
    leaves, finite [K, n] or None)."""
    losses = torch.stack([r[0] for r in results])
    stats = {name: {key: torch.stack([r[1][name][key] for r in results])
                    for key in results[0][1][name]}
             for name in results[0][1]}
    finite = (None if results[0][2] is None
              else torch.stack([r[2] for r in results]))
    return losses, stats, finite


def _train_metrics():
    """The four process-wide training metrics under the JAX package's
    series names (paddle_tpu/trainer.py:451-470); a training-fleet worker
    labels them."""
    m = observe_metrics.get_registry()
    wid = observe_trainview.worker_id()
    labels = {"worker": wid} if wid is not None else None
    return (m.counter("paddle_tpu_train_steps_total",
                      help="finalized training steps", labels=labels),
            m.counter("paddle_tpu_train_examples_total",
                      help="examples consumed by training steps",
                      labels=labels),
            m.gauge("paddle_tpu_train_loss",
                    help="last finalized step loss", labels=labels),
            m.gauge("paddle_tpu_train_examples_per_sec",
                    help="examples/s of the last finalized step",
                    labels=labels))


class _Telemetry:
    """One train() call's observability: the steplog (None unless
    telemetry is on) and the Chrome-trace export of the spans when the run
    ends, the sentinel, the four training metrics, the per-worker health
    history and the finalize clock whose laps are the ``wall_ms`` of the
    step and chunk records. Every method works on values finalize already
    holds on the host."""

    def __init__(self, trainer, num_passes, k):
        dev = trainer.device
        meta = {"phase": "train", "num_passes": int(num_passes),
                "backend": dev.type,
                "device_count": (torch.cuda.device_count()
                                 if dev.type == "cuda" else 1),
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda}
        if dev.type == "cuda":
            meta["device_name"] = torch.cuda.get_device_name(dev)
        if k:
            meta["steps_per_call"] = k
        wid = observe_trainview.worker_id()
        run_name = "train"
        if wid is not None:
            meta["worker"] = wid
            run_name = observe_trainview.worker_run_name("train", wid)
        self.tracer = observe_spans.get_tracer()
        self.slog = observe_steplog.from_env(run_name=run_name, meta=meta)
        self._prev_recording = self.tracer.record_events
        if self.slog is not None:
            # this run exports a trace: record every span, from now on
            self.tracer.record_events = True
            self.tracer.reset()
        self.sentinel = observe_sentinel.from_env(
            steplog=self.slog, run_name=run_name, worker=wid)
        (self.m_steps, self.m_examples, self.m_loss,
         self.m_examples_per_sec) = _train_metrics()
        self.history = observe_trainview.get_train_history()
        # the first interval starts with the run, so the first record
        # includes the first step's warm-up (kernel loads, a capture)
        self._last = time.perf_counter()

    def lap(self):
        """Milliseconds since the last lap (or reset)."""
        now = time.perf_counter()
        ms = (now - self._last) * 1e3
        self._last = now
        return ms

    def reset_clock(self):
        self._last = time.perf_counter()

    def feed(self, step, fb, depth):
        if self.slog is not None:
            self.slog.log_feed(step=step, stall_ms=fb.stall_ms,
                               convert_ms=fb.convert_ms,
                               examples=fb.examples, depth=depth,
                               bucket=fb.bucket, fill_tokens=fb.fill_tokens,
                               pad_tokens=fb.pad_tokens)

    def step(self, gstep, pass_id, b_id, cost, examples, metrics, feed_ms,
             wall_ms, chunk_index):
        """One finalized step. A step of a fused chunk (``chunk_index``
        set) has no interval of its own and is only checked by the
        sentinel; the chunk's ring record and interval came through
        :meth:`chunk`."""
        if self.slog is not None:
            self.slog.log_step(step=gstep, pass_id=pass_id, batch_id=b_id,
                               wall_ms=wall_ms, feed_ms=feed_ms, cost=cost,
                               examples=examples, metrics=metrics)
        self.m_steps.inc()
        self.m_examples.inc(examples)
        self.m_loss.set(cost)
        if chunk_index is not None:
            if self.sentinel is not None:
                self.sentinel.check(gstep, cost, pass_id=pass_id,
                                    chunk_index=chunk_index)
            return
        if wall_ms > 0:
            self.m_examples_per_sec.set(examples / wall_ms * 1000.0)
        self.history.record_step(wall_ms, examples=examples,
                                 feed_stall_ms=feed_ms)
        if self.sentinel is not None:
            # halt mode raises TrainingAnomaly here, its black box dumped
            self.sentinel.step(gstep, cost=cost, pass_id=pass_id,
                               batch_id=b_id, wall_ms=round(wall_ms, 4))

    def chunk(self, base_step, pass_id, b_id, costs, chunk):
        """One fused chunk at its finalize, before its steps."""
        wall_ms = self.lap()
        n = len(costs)
        if self.slog is not None:
            self.slog.log_train_chunk(
                step=base_step + 1, steps=n, pass_id=pass_id, batch_id=b_id,
                wall_ms=wall_ms, feed_ms=chunk.stall_ms,
                cost_first=float(costs[0]), cost_last=float(costs[-1]),
                examples=chunk.examples)
        if wall_ms > 0:
            self.m_examples_per_sec.set(chunk.examples / wall_ms * 1000.0)
        self.history.record_chunk(n, wall_ms, examples=chunk.examples,
                                  feed_stall_ms=chunk.stall_ms)
        if self.sentinel is not None:
            self.sentinel.record_chunk(base_step + 1, costs, pass_id=pass_id,
                                       batch_id=b_id,
                                       wall_ms=round(wall_ms, 4))

    def on_exception(self, exc):
        if self.sentinel is not None:
            self.sentinel.on_exception(exc)

    def close(self):
        if self.slog is not None:
            try:
                self.tracer.export(self.slog.trace_path)
            finally:
                self.tracer.record_events = self._prev_recording
                self.slog.close()


def default_event_handler(evt):
    pass


def _fmt_metrics(metrics):
    return " ".join("%s=%.5f" % (key, val) for key, val in metrics.items()
                    if isinstance(val, float))
