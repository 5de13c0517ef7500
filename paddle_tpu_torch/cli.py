"""Command-line entry of the port (paddle_tpu/cli.py; reference
paddle/trainer/TrainerMain.cpp, jobs train/test/time):

    python -m paddle_tpu_torch.cli train --config conf.py --num-passes 5 \
        [--config-args k=v,...] [--steps-per-call 10] [--device cpu]
    python -m paddle_tpu_torch.cli test  --config conf.py --params p.tar
    python -m paddle_tpu_torch.cli time  --config conf.py --iters 20
    python -m paddle_tpu_torch.cli checkgrad --config conf.py
    python -m paddle_tpu_torch.cli observe TELEMETRY_DIR [--json]
    python -m paddle_tpu_torch.cli export \
        --builder paddle_tpu_torch.models.text:text_classification_lstm \
        --builder-kwargs '{"hidden": 256, "num_layers": 2}' \
        [--params params.npz | --seed 0 [--device cpu]] [--quantize int8] \
        [--decode-slots 48 --decode-window 6] -o BUNDLE_DIR
    python -m paddle_tpu_torch.cli serve BUNDLE_DIR [--selfcheck] [--port N] \
        [--continuous [--session-store N] [--idle-spill-ms MS] \
         [--session-slo-ms MS] [--session-ttl-ms MS]]
    python -m paddle_tpu_torch.cli generate BUNDLE_DIR --prime 5,17,3 \
        [--steps 32] [--temperature 0] [--seed 0] [--json]

A --config file is a Python module: either a v1 config (``from
paddle.trainer_config_helpers import *``, ``settings()``, layers,
``outputs()``, ``define_py_data_sources2``; the port's own ``paddle`` shim
under paddle_tpu_torch/compat answers those imports) or one that defines
``cost()`` and may define ``optimizer()``, ``evaluators()``,
``train_reader()``, ``test_reader()`` and ``batch_size``. ``train``,
``test``, ``time`` and ``checkgrad`` (the float64 gradient check of
checkgrad.py) run on the card unless ``--device cpu``; the
arguments are the JAX package's, keyword for keyword. With
``PADDLE_TPU_TORCH_TELEMETRY=<dir>`` training writes its step log and span
trace there, which ``observe`` summarizes (either package's directories).

``export`` takes ``--params``, an npz written by either package's
``Parameters.to_npz`` (a JAX bundle's params.npz included); without it the
parameters are initialised from ``--seed`` on the card (or ``--device
cpu``). ``--quantize int8`` writes a quantized bundle (serve/quantize.py),
which ``serve`` runs unchanged. ``--decode-slots`` adds the
continuous-batching decode step of a streamable topology, which ``serve
--continuous`` runs through the scheduler with its session tier and
``generate`` loops for streaming generation (serve/generate.py).
``serve`` and ``generate`` run on the card unless ``--device cpu``.

Not ported yet, and refused: ``cluster_train``,
``merge_model``, ``analyze``, ``observe --regress`` and ``--fleet-stats``,
``serve --session-store-addr``, and ``--trainer-count`` above 1.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

from paddle_tpu_torch.utils.error import enforce

COMPAT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "compat")
CONFIG_MODULE = "paddle_tpu_torch_user_config"


class ConfigScope:
    """The import scope of one config file: the port's compat directory
    and the config's own directory at the front of ``sys.path``; every
    ``paddle`` / ``paddle.*`` module and every module loaded from the
    config's directory set aside on entry, and exactly those entries put
    back on exit. The JAX package's shim and a module of the same name
    imported under it never answer for the port, and the port's never stay
    behind for the JAX package.

    The modules the scope imported (the port's shim, the config's
    providers) are kept and come back on every later entry, so a provider
    that the data source imports lazily, when the reader is made, still
    resolves to the port's shim (:meth:`wrap`)."""

    def __init__(self, config_path):
        self.config_dir = os.path.dirname(os.path.abspath(config_path))
        self.modules = {}
        self._saved = None

    def _owned(self, name, module):
        top = name.split(".")[0]
        if top == "paddle" or name == CONFIG_MODULE:
            return True
        if top in ("paddle_tpu", "paddle_tpu_torch", "__main__"):
            return False
        path = getattr(module, "__file__", None)
        return bool(path) and os.path.abspath(path).startswith(
            self.config_dir + os.sep)

    def __enter__(self):
        self._saved = {n: m for n, m in list(sys.modules.items())
                       if self._owned(n, m)}
        for name in self._saved:
            del sys.modules[name]
        sys.modules.update(self.modules)
        sys.path[:0] = [COMPAT_DIR, self.config_dir]
        return self

    def __exit__(self, *exc):
        for path in (COMPAT_DIR, self.config_dir):
            sys.path.remove(path)
        for name, module in list(sys.modules.items()):
            if self._owned(name, module):
                self.modules[name] = module
                del sys.modules[name]
        sys.modules.update(self._saved)
        self._saved = None

    def wrap(self, fn):
        """``fn`` called inside the scope."""
        def scoped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return scoped


def _load_config(path, config_args=""):
    """Execute a config file in its :class:`ConfigScope` and adapt a v1
    config's declarations (settings/outputs/data sources) onto the
    ``cost()``/``optimizer()``/``train_reader()`` surface the commands
    use (paddle_tpu/cli.py:28-78). The layer-name counters start from zero,
    so a config loaded twice in one process (``train`` then ``test``)
    names its layers and parameters as a fresh process would."""
    from paddle_tpu_torch import config as cfgmod
    from paddle_tpu_torch.graph import reset_name_counters

    reset_name_counters()
    cfgmod.reset()
    cfgmod.set_config_args(config_args)
    scope = ConfigScope(path)
    with scope:
        spec = importlib.util.spec_from_file_location(CONFIG_MODULE, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[CONFIG_MODULE] = mod
        # py2-era configs (the reference is a 2017 codebase) may use xrange
        mod.xrange = range
        spec.loader.exec_module(mod)
    mod.config_scope = scope
    st = cfgmod.pop_config()
    if st is not None:
        outputs = st["outputs"]
        if outputs and not hasattr(mod, "cost"):
            mod.cost = (lambda: outputs[0] if len(outputs) == 1
                        else outputs)
        if not hasattr(mod, "optimizer") and st["settings"].get("optimizer"):
            mod.optimizer = lambda: st["settings"]["optimizer"]
        if st["settings"].get("batch_size") and not hasattr(mod,
                                                            "batch_size"):
            mod.batch_size = st["settings"]["batch_size"]
        ds = st["data_sources"]
        if "train" in ds and not hasattr(mod, "train_reader"):
            mod.train_reader = scope.wrap(ds["train"])
        if "test" in ds and not hasattr(mod, "test_reader"):
            mod.test_reader = scope.wrap(ds["test"])
    return mod


def _build(cfg, device=None):
    """(cost, parameters, trainer) of a loaded config on ``device`` (the
    card unless "cpu")."""
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.trainer import SGD

    cost = cfg.cost()
    params = Parameters.create(cost, device=device)
    optimizer = (cfg.optimizer() if hasattr(cfg, "optimizer")
                 else opt.Momentum(learning_rate=0.01, momentum=0.9))
    extra = list(cfg.evaluators()) if hasattr(cfg, "evaluators") else None
    trainer = SGD(cost, params, optimizer, extra_layers=extra, device=device)
    return cost, params, trainer


def cmd_train(args):
    from paddle_tpu_torch import event as v2_event
    from paddle_tpu_torch import minibatch

    cfg = _load_config(args.config, args.config_args)
    _, _, trainer = _build(cfg, args.device)
    batch_size = getattr(cfg, "batch_size", args.batch_size)
    reader = minibatch.batch(cfg.train_reader(), batch_size)
    if args.init_model:
        trainer.restore_checkpoint(args.init_model)
    save_dir = args.save_dir

    def handler(event):
        if isinstance(event, v2_event.EndPass) and save_dir:
            trainer.save_checkpoint(save_dir, pass_id=event.pass_id)

    trainer.train(reader, num_passes=args.num_passes, event_handler=handler,
                  feed_pipeline=args.feed_pipeline or False,
                  steps_per_call=args.steps_per_call or None,
                  checkpoint_dir=args.checkpoint_dir or None,
                  checkpoint_every=args.checkpoint_every,
                  checkpoint_keep=args.checkpoint_keep,
                  checkpoint_sync=args.checkpoint_sync, resume=args.resume)
    if hasattr(cfg, "test_reader"):
        result = trainer.test(minibatch.batch(cfg.test_reader(), batch_size))
        print("test cost=%.6f metrics=%s" % (result.cost, result.metrics))
    return 0


def cmd_test(args):
    from paddle_tpu_torch import minibatch

    cfg = _load_config(args.config, args.config_args)
    _, params, trainer = _build(cfg, args.device)
    if args.params:
        with open(args.params, "rb") as f:
            params.init_from_tar(f)
        # the trainer staged the initial values when it was built
        trainer.stage_parameters()
    result = trainer.test(minibatch.batch(
        cfg.test_reader(), getattr(cfg, "batch_size", args.batch_size)))
    print("test cost=%.6f metrics=%s" % (result.cost, result.metrics))
    return 0


def cmd_time(args):
    """--job=time parity (TrainerBenchmark.cpp): steady-state ms per batch,
    one train() call a batch after a warm-up call, ended by a synchronize
    of the card (paddle_tpu/cli.py:169-196)."""
    import torch

    from paddle_tpu_torch import minibatch

    cfg = _load_config(args.config, args.config_args)
    _, _, trainer = _build(cfg, args.device)
    batch_size = getattr(cfg, "batch_size", args.batch_size)
    batches = list(minibatch.batch(cfg.train_reader(), batch_size)())
    if not batches:
        print("no data")
        return 1
    feed_batches = batches[: max(args.iters, 1)]

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    trainer.train(lambda: iter(feed_batches[:1]), num_passes=1)  # warm-up
    sync()
    start = time.perf_counter()
    for batch in feed_batches:
        trainer.train(lambda b=batch: iter([b]), num_passes=1,
                      sync_params=False)
    sync()
    elapsed = (time.perf_counter() - start) / len(feed_batches) * 1000.0
    print(json.dumps({"ms_per_batch": round(elapsed, 3),
                      "batch_size": batch_size,
                      "batches": len(feed_batches)}))
    return 0


def cmd_checkgrad(args):
    """--job=checkgrad parity (paddle_tpu/cli.py cmd_checkgrad): the
    numeric-against-analytic gradient check in float64 over the config's
    cost, on its first training batch."""
    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.checkgrad import check_layer_grad
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.topology import Topology, convert_feed

    cfg = _load_config(args.config, args.config_args)
    cost = cfg.cost()
    device = resolve_device(args.device)
    batch = next(iter(minibatch.batch(cfg.train_reader(),
                                      getattr(cfg, "batch_size", 8))()))
    feed = convert_feed(Topology(cost), batch, device)
    check_layer_grad(cost, feed, check_inputs=False, device=device)
    print("checkgrad PASSED")
    return 0


def _not_ported(verb, needs):
    def refuse(args):
        raise NotImplementedError("cli %s is not ported yet: it needs %s"
                                  % (verb, needs))

    refuse.refuses = True  # takes any arguments: it reads none of them
    return refuse


def cmd_observe(args):
    """Summarize a telemetry directory (either package's): per-run step
    counts, steady-state wall-time p50/p95/p99, event totals, feed
    stalls, checkpoints, the training-fleet block (observe/trainview.py)
    and the trace files to open in Perfetto — the JAX package's report,
    line for line. ``--regress`` and ``--fleet-stats`` are not ported
    yet."""
    from paddle_tpu_torch.observe import steplog

    enforce(not args.regress, "cli observe --regress is not ported yet: "
            "it needs observe/regress.py")
    enforce(not args.fleet_stats, "cli observe --fleet-stats is not ported "
            "yet: it needs the coordinator (distributed/)")
    summary = steplog.summarize_dir(args.directory)
    if args.json:
        print(json.dumps(summary, indent=2))
        return 0
    print("telemetry dir: %s" % summary["directory"])
    for run in summary["runs"]:
        print("  run %-12s schema=%s backend=%-5s steps=%-5d "
              "compile_events=%d (%.2fs)"
              % (run.get("run"), run.get("schema"), run.get("backend"),
                 run["steps"], run["compile_events"],
                 run["event_secs_total"]))
        if "wall_ms_steady_mean" in run:
            print("    wall ms/step: steady p50 %.3f  p95 %.3f  "
                  "p99 %.3f  mean %.3f  min %.3f  "
                  "(first-step mean incl. compile %.3f)"
                  % (run["wall_ms_p50"], run["wall_ms_p95"],
                     run["wall_ms_p99"], run["wall_ms_steady_mean"],
                     run["wall_ms_min"], run["wall_ms_mean"]))
        if "feed_stall_ms_p50" in run:
            waste = ("  padding waste %.1f%%"
                     % run["feed_padding_waste_pct"]
                     if "feed_padding_waste_pct" in run else "")
            print("    feed stall ms: p50 %.3f  p95 %.3f  "
                  "(%d pipelined batches)%s"
                  % (run["feed_stall_ms_p50"], run["feed_stall_ms_p95"],
                     run["feed_batches"], waste))
        if "checkpoints" in run:
            thread = (", step-thread p95 %.3f ms"
                      % run["checkpoint_step_thread_ms_p95"]
                      if "checkpoint_step_thread_ms_p95" in run else "")
            print("    checkpoints: %d  save p95 %.3f ms  %.1f KB total%s"
                  % (run["checkpoints"], run["checkpoint_ms_p95"],
                     run["checkpoint_bytes_total"] / 1024.0, thread))
        if "examples_per_sec_best" in run:
            print("    examples/sec best: %.1f"
                  % run["examples_per_sec_best"])
        if "cost_last" in run:
            print("    cost: first %.6f -> last %.6f"
                  % (run["cost_first"], run["cost_last"]))
        # a WorkerSet's per-worker steplog file carries the worker
        # index in its meta: label its lines "worker" so per-worker
        # qps/occupancy reads next to the in-process per-replica lines
        member = ("worker" if run.get("serve_worker") is not None
                  else "replica")
        for rep, s in sorted(run.get("serve_replicas", {}).items()):
            print("    serve %s %-4s dispatches %-6d "
                  "completed %-6d%s%s"
                  % (member, rep, s["dispatches"], s["completed"],
                     ("  qps %.1f" % s["qps"]) if "qps" in s else "",
                     ("  occupancy %.2f" % s["occupancy_mean"])
                     if "occupancy_mean" in s else ""))
            if "spills" in s or "resident_sessions" in s:
                # session tier: paging activity + where the sessions sit
                swaps = ("spills %d restores %d evictions %d"
                         % (s.get("spills", 0), s.get("restores", 0),
                            s.get("evictions", 0)))
                rate = ("  swap/s %.1f" % s["swap_per_s"]
                        if "swap_per_s" in s else "")
                counts = ""
                if "resident_sessions" in s or "suspended_sessions" in s:
                    counts = ("  sessions resident %d / suspended %d"
                              % (s.get("resident_sessions", 0),
                                 s.get("suspended_sessions", 0)))
                print("      session swaps: %s%s%s" % (swaps, rate, counts))
        if "serve_tail" in run:
            # tail attribution over the run's sampled serve_trace
            # records: the phase histogram of the p99 — "p99 is 80%
            # queue-wait" vs "80% spill-restore" in one line
            tail = run["serve_tail"]
            shares = "  ".join(
                "%s %.1f%%" % (k[:-len("_ms")] if k.endswith("_ms")
                               else k, v)
                for k, v in sorted(tail["phases"].items(),
                                   key=lambda kv: -kv[1]))
            print("    serve tail attribution (p%g >= %.1f ms, "
                  "%d of %d traced): %s"
                  % (tail["q"], tail["threshold_ms"],
                     tail["tail_requests"], tail["requests"], shares))
        if "control_actions" in run:
            # the knob-move timeline, next to the tail attribution the
            # moves were reacting to: what the controller did, in
            # order, with the burn it was fighting
            moves = run["control_actions"]
            print("    control timeline: %d knob move(s), %d rollback(s)"
                  % (len(moves), run.get("control_rollbacks", 0)))
            for a in moves:
                burn = ("  burn %.2f" % a["burn_rate_before"]
                        if "burn_rate_before" in a else "")
                phase = (" [%s]" % a["breaching_phase"]
                         if "breaching_phase" in a else "")
                print("      t=%-8.2f %-24s %g -> %g  %s%s%s"
                      % (a.get("t", 0.0), a["knob"], a["old"], a["new"],
                         a["reason"], phase, burn))
    for fleet in summary.get("fleets", ()):
        # fleet-merged tail attribution across a WorkerSet's per-worker
        # steplog files: the per-file p99 above is each worker's OWN
        # tail — this is the fleet's, pooled before the percentile
        tail = fleet["serve_tail"]
        shares = "  ".join(
            "%s %.1f%%" % (k[:-len("_ms")] if k.endswith("_ms") else k,
                           v)
            for k, v in sorted(tail["phases"].items(),
                               key=lambda kv: -kv[1]))
        print("  fleet %s merged tail attribution (p%g >= %.1f ms, "
              "%d of %d traced across %d workers): %s"
              % (fleet["run"], tail["q"], tail["threshold_ms"],
                 tail["tail_requests"], tail["requests"],
                 len(fleet["workers"]), shares))
        breakdown = "  ".join(
            "w%s p99 %s (%d traced)"
            % (widx, ("%.1f ms" % w["p99_ms"]) if "p99_ms" in w
               else "n/a", w["traces"])
            for widx, w in sorted(fleet["workers"].items(),
                                  key=lambda kv: int(kv[0])))
        print("    per-worker: %s" % breakdown)
    for cluster in summary.get("serve_clusters", ()):
        # cluster-merged tail attribution across per-HOST steplog files
        # (run names "<run>@<host>"): each host's own p99 is blind to
        # the cluster's true tail — pool before the percentile
        tail = cluster["serve_tail"]
        shares = "  ".join(
            "%s %.1f%%" % (k[:-len("_ms")] if k.endswith("_ms") else k,
                           v)
            for k, v in sorted(tail["phases"].items(),
                               key=lambda kv: -kv[1]))
        print("  cluster %s merged tail attribution (p%g >= %.1f ms, "
              "%d of %d traced across %d hosts): %s"
              % (cluster["run"], tail["q"], tail["threshold_ms"],
                 tail["tail_requests"], tail["requests"],
                 len(cluster["hosts"]), shares))
        breakdown = "  ".join(
            "%s p99 %s (%d traced)"
            % (hid, ("%.1f ms" % h["p99_ms"]) if "p99_ms" in h
               else "n/a", h["traces"])
            for hid, h in sorted(cluster["hosts"].items()))
        print("    per-host: %s" % breakdown)
    sh = summary.get("serve_hosts")
    if sh:
        # the serving-host membership timeline — the serving twin of
        # the elastic timeline below, on the same absolute time axis
        print("  serving hosts timeline: %d event(s), %d session "
              "rehome(s)" % (len(sh["events"]), sh["rehomes"]))
        for e in sh["events"]:
            extras = []
            if e.get("hosts") is not None:
                extras.append("hosts=[%s]" % ",".join(e["hosts"]))
            if e.get("session"):
                extras.append("session=%s" % e["session"])
            if e.get("target"):
                extras.append("target=%s" % e["target"])
            if e.get("detail"):
                extras.append("(%s)" % e["detail"])
            print("    at=%.3f %-16s host=%-16s %s"
                  % (e["t_abs"], e["kind"], e.get("host", "-"),
                     "  ".join(extras)))
    tf = summary.get("train_fleet")
    if tf:
        # the training-fleet block (observe/trainview.py): per-worker
        # step-time skew against the fleet-pooled median, the straggler
        # verdict, and the merged elastic timeline
        skew = tf.get("skew")
        if skew:
            straggler = tf.get("straggler")
            rewinds = ("  rewinds %d" % tf["rewinds"]
                       if tf.get("rewinds") else "")
            print("  training fleet: %d worker(s), fleet median "
                  "%.3f ms/step%s"
                  % (len(skew["workers"]), skew["fleet_median_ms"],
                     rewinds))
            for wid, w in sorted(skew["workers"].items()):
                mark = (" <- straggler" if straggler
                        and straggler["worker"] == wid else "")
                print("    worker %-12s steps %-5d p50 %.3f ms  "
                      "p95 %.3f ms  skew %.2f%s"
                      % (wid, w.get("steps", 0), w["p50_ms"],
                         w["p95_ms"], w["skew"], mark))
            if straggler:
                from paddle_tpu_torch.observe.trainview import (
                    DEFAULT_SKEW_THRESHOLD)

                print("    straggler: %s (skew %.2f >= %.2f)"
                      % (straggler["worker"], straggler["skew"],
                         DEFAULT_SKEW_THRESHOLD))
        timeline = tf.get("timeline")
        if timeline:
            print("  elastic timeline: %d event(s)" % len(timeline))
            for e in timeline:
                extras = []
                if e.get("members") is not None:
                    extras.append("members=[%s]"
                                  % ",".join(e["members"]))
                if e.get("lost") is not None:
                    extras.append("lost=[%s]" % ",".join(e["lost"]))
                if e.get("checkpoint"):
                    extras.append("checkpoint=%s" % e["checkpoint"])
                if e.get("step") is not None:
                    extras.append("step=%d" % e["step"])
                if e.get("detail"):
                    extras.append("(%s)" % e["detail"])
                print("    at=%.3f %-18s worker=%-12s %s"
                      % (e["at"], e["kind"], e.get("worker", "-"),
                         "  ".join(extras)))
    if summary["trace_files"]:
        print("  traces (open in https://ui.perfetto.dev): %s"
              % ", ".join(summary["trace_files"]))
    if not summary["runs"]:
        print("  no *.steps.jsonl runs found")
    return 0


def cmd_export(args):
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve.bundle import build_outputs
    from paddle_tpu_torch.serve.export import export_bundle, parse_builder
    from paddle_tpu_torch.topology import Topology

    builder = parse_builder(args.builder, json.loads(args.builder_kwargs))
    if args.params:
        params = Parameters.from_npz(args.params)
    else:
        params = Parameters.create(Topology(build_outputs(builder)),
                                   seed=args.seed,
                                   device=args.device or None)
    manifest = export_bundle(
        builder, params, args.output,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",") if b],
        seq_len=args.seq_len, name=args.name or None,
        decode_slots=[int(n) for n in args.decode_slots.split(",") if n],
        decode_window=args.decode_window, quantize=args.quantize or None)
    summary = {"bundle": args.output, "name": manifest["name"],
               "buckets": [b["batch"] for b in manifest["buckets"]],
               "inputs": [i["name"] for i in manifest["inputs"]],
               "outputs": manifest["outputs"]}
    if manifest.get("quantization"):
        summary["quantization"] = manifest["quantization"]["scheme"]
    if manifest.get("decode"):
        summary["decode_slots"] = [b["slots"] for b in
                                   manifest["decode"]["slots"]]
        summary["decode_window"] = manifest["decode"]["window"]
    print(json.dumps(summary))
    return 0


def _make_engine(bundle, args, warmup):
    """The batching engine, or with ``--continuous`` the continuous
    scheduler and its session tier (paddle_tpu/cli.py ``_make_engine``,
    one engine per process: the replica fleets are not ported yet)."""
    from paddle_tpu_torch.serve import ContinuousScheduler, InferenceEngine

    if not args.continuous:
        return InferenceEngine(bundle, max_batch_size=args.max_batch_size,
                               max_latency_ms=args.max_latency_ms,
                               warmup=warmup)
    return ContinuousScheduler(
        bundle, warmup=warmup, max_queue=None,
        session_capacity=args.session_store,
        idle_spill_ms=args.idle_spill_ms,
        session_slo_grace_ms=args.session_slo_ms,
        session_ttl_ms=args.session_ttl_ms)


def cmd_serve(args):
    from paddle_tpu_torch.serve.bundle import load_bundle
    from paddle_tpu_torch.serve.server import make_server

    enforce(not args.session_store_addr, "serve --session-store-addr is not "
            "ported yet: it needs the remote session store "
            "(serve/remote_store.py)")
    bundle = load_bundle(args.bundle, device=args.device or None)
    if args.continuous and not bundle.has_decoder():
        # refuse loudly: a silent fall-back to the padding engine would
        # leave the operator believing continuous batching is active
        print("--continuous: bundle %r has no decode artifacts; "
              "re-export with --decode-slots" % bundle.name,
              file=sys.stderr)
        return 2
    # selfcheck warms synchronously (it IS the warmth gate); serving warms
    # on a thread so /readyz honestly answers 503 until every bucket ran
    engine = _make_engine(bundle, args,
                          warmup=True if args.selfcheck else "async")
    try:
        if args.selfcheck:
            out = engine.infer(bundle.dummy_inputs(rows=1), timeout=300.0)
            print(json.dumps({
                "ok": True, "bundle": bundle.name,
                "device": str(bundle.device),
                "buckets": bundle.batch_sizes(),
                "outputs": {k: list(v.shape) for k, v in out.items()},
                "stats": {k: v for k, v in engine.stats().items()
                          if isinstance(v, int)}}))
            return 0
        server = make_server(bundle, engine, host=args.host, port=args.port)
        print("serving %r on http://%s:%d (POST /infer; GET /healthz "
              "/readyz)" % (bundle.name, *server.server_address), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    finally:
        engine.stop()


def cmd_generate(args):
    """Streaming generation over a decode-capable bundle: the decode step
    looped on the host, each picked y_t fed back as x_{t+1}; greedy at
    --temperature 0 (default), seeded sampling above. Prints one JSON
    line, as the JAX CLI does (``--json`` names that output)."""
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.generate import generate

    bundle = load_bundle(args.bundle, device=args.device or None)
    prime = [int(t) for t in args.prime.split(",") if t.strip()]
    out = generate(bundle, prime, args.steps, temperature=args.temperature,
                   seed=args.seed, slots=args.slots)
    print(json.dumps(out))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", required=True)
    common.add_argument("--config-args", default="",
                        help="k=v,... template parameters readable via "
                             "paddle_tpu_torch.config.get_config_arg")
    common.add_argument("--batch-size", type=int, default=64)
    common.add_argument("--trainer-count", type=int, default=None,
                        help="data-parallel width (reference "
                             "--trainer_count); only 1 is ported")
    common.add_argument("--device", default=None,
                        help="torch device (default: the card)")

    p = sub.add_parser("train", parents=[common])
    p.add_argument("--num-passes", type=int, default=1)
    p.add_argument("--save-dir", default="",
                   help="checkpoint directory written at every EndPass")
    p.add_argument("--init-model", default="",
                   help="checkpoint (directory) of either package to start "
                        "from")
    p.add_argument("--feed-pipeline", type=int, default=0,
                   help="pipelined input feed depth (data/feeder.py); "
                        "0 = synchronous feed")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="fuse K optimizer steps per dispatch (one captured "
                        "CUDA graph replay on the card); implies the "
                        "pipelined feed; 0 = one dispatch per step")
    p.add_argument("--checkpoint-dir", default="",
                   help="durable full-training-state checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence in global steps; saves are "
                        "overlapped (ckpt-writer thread) unless "
                        "--checkpoint-sync; 0 = off")
    p.add_argument("--checkpoint-keep", type=int, default=3,
                   help="checkpoints retained (older ones pruned)")
    p.add_argument("--checkpoint-sync", action="store_true",
                   help="block the step thread for each save")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest valid checkpoint in "
                        "--checkpoint-dir and continue the same trajectory")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("test", parents=[common])
    p.add_argument("--params", default="",
                   help="parameter tar (either package's)")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("time", parents=[common])
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_time)

    p = sub.add_parser("observe")
    p.add_argument("directory",
                   help="telemetry directory (PADDLE_TPU_TORCH_TELEMETRY)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary")
    p.add_argument("--regress", default="", help="not ported yet")
    p.add_argument("--regress-tol", type=float, default=10.0,
                   help="not ported yet")
    p.add_argument("--fleet-stats", default="", metavar="HOST:PORT",
                   help="not ported yet")
    p.set_defaults(fn=cmd_observe)

    p = sub.add_parser("checkgrad", parents=[common])
    p.set_defaults(fn=cmd_checkgrad)

    for verb, needs in (
            ("cluster_train", "distributed/ (the launcher and coordinator)"),
            ("merge_model", "the model proto (proto/)"),
            ("analyze", "analyze/")):
        p = sub.add_parser(verb, help="not ported yet")
        p.set_defaults(fn=_not_ported(verb, needs))

    p = sub.add_parser("export", help="write a serving bundle")
    p.add_argument("--builder", required=True,
                   help="module.path:function returning the output layer")
    p.add_argument("--builder-kwargs", default="{}",
                   help="JSON object of keyword arguments for the builder")
    p.add_argument("--params", default="",
                   help="parameter npz (Parameters.to_npz of either package)")
    p.add_argument("--seed", type=int, default=0,
                   help="initialisation seed when --params is not given")
    p.add_argument("--device", default="",
                   help="torch device that initialises the parameters "
                        "(default: the card)")
    p.add_argument("-o", "--output", required=True,
                   help="bundle directory to write")
    p.add_argument("--batch-sizes", default="1,8,32",
                   help="comma-separated batch buckets")
    p.add_argument("--seq-len", type=int, default=None,
                   help="padded time dim for sequence inputs (default 64)")
    p.add_argument("--name", default="")
    p.add_argument("--quantize", default="", choices=("", "int8"),
                   help="weight-only quantization: int8 stores matmul/conv "
                        "weights per-output-channel symmetric int8 with "
                        "float32 scale sidecars (biases, norm and embedding "
                        "tables and recurrent cells stay fp)")
    p.add_argument("--decode-slots", default="",
                   help="comma-separated slot capacities: add the "
                        "continuous-batching decode step (streamable "
                        "recurrent topologies only)")
    p.add_argument("--decode-window", type=int, default=None,
                   help="decode timesteps per dispatch (default 8)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("generate", help="streaming generation")
    p.add_argument("bundle", help="decode-capable bundle directory "
                                  "(exported with --decode-slots)")
    p.add_argument("--prime", required=True,
                   help="comma-separated token ids to prime the carry "
                        "with (e.g. 5,17,3)")
    p.add_argument("--steps", type=int, default=32,
                   help="tokens to generate after the prime")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax; >0 samples from the "
                        "temperature-scaled distribution")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (reproducible output)")
    p.add_argument("--slots", type=int, default=None,
                   help="decode slot capacity to use (default: the "
                        "largest exported)")
    p.add_argument("--json", action="store_true",
                   help="the output is one JSON line (always)")
    p.add_argument("--device", default="",
                   help="torch device (default: the card)")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("serve", help="serve a bundle over HTTP")
    p.add_argument("bundle")
    p.add_argument("--selfcheck", action="store_true",
                   help="load, warm, run one batch, exit (smoke gate)")
    p.add_argument("--device", default="",
                   help="torch device (default: the card)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8866)
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--max-latency-ms", type=float, default=5.0)
    p.add_argument("--continuous", action="store_true",
                   help="front a decode-capable bundle with the "
                        "continuous-batching scheduler instead of the "
                        "padding engine")
    p.add_argument("--session-store", type=int, default=4096,
                   help="session tier (--continuous): host-store capacity "
                        "in suspended sessions; an evicted session answers "
                        "410 Gone")
    p.add_argument("--idle-spill-ms", type=float, default=None,
                   help="session tier: spill a parked session's carry to "
                        "the host store after this much idle time "
                        "(default: spill only under slot pressure)")
    p.add_argument("--session-slo-ms", type=float, default=None,
                   help="session tier: eviction passes over sessions "
                        "touched within this SLO grace window while any "
                        "other candidate exists")
    p.add_argument("--session-ttl-ms", type=float, default=None,
                   help="session tier: evict suspended sessions idle past "
                        "this TTL (reason=ttl)")
    p.add_argument("--session-store-addr", default="", metavar="HOST:PORT",
                   help="not ported yet")
    p.set_defaults(fn=cmd_serve)

    args, extra = parser.parse_known_args(argv)
    if extra and not getattr(args.fn, "refuses", False):
        parser.error("unrecognized arguments: %s" % " ".join(extra))
    tc = getattr(args, "trainer_count", None)
    enforce(not tc or tc == 1, "--trainer-count %d: data parallelism is not "
            "ported yet", tc or 0)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
