"""Command-line entry of the port (paddle_tpu/cli.py; reference
paddle/trainer/TrainerMain.cpp, jobs train/test/time):

    python -m paddle_tpu_torch.cli train --config conf.py --num-passes 5 \
        [--config-args k=v,...] [--steps-per-call 10] [--device cpu] \
        [--trainer-count N]
    python -m paddle_tpu_torch.cli test  --config conf.py --params p.tar
    python -m paddle_tpu_torch.cli time  --config conf.py --iters 20
    python -m paddle_tpu_torch.cli checkgrad --config conf.py
    python -m paddle_tpu_torch.cli cluster_train --config conf.py \
        --num-processes 2 [--num-passes 1] [--devices-per-process k] \
        [--device cpu]
    python -m paddle_tpu_torch.cli observe TELEMETRY_DIR [--json] \
        [--fleet-stats HOST:PORT]
    python -m paddle_tpu_torch.cli export \
        (--builder paddle_tpu_torch.models.text:text_classification_lstm \
         [--builder-kwargs '{"hidden": 256, "num_layers": 2}'] \
         | --config conf.py [--config-args k=v,...]) \
        [--params params.tar | --seed 0] [--device cpu] \
        [--platforms cpu,cuda] [--quantize int8] \
        [--decode-slots 48 --decode-window 6] -o BUNDLE_DIR
    python -m paddle_tpu_torch.cli merge_model \
        (--builder MODULE:FUNCTION [--builder-kwargs JSON] \
         | --config conf.py) --params params.tar -o merged.tar
    python -m paddle_tpu_torch.cli serve BUNDLE_DIR [--selfcheck] [--port N] \
        [--max-queue-rows N] [--slo-p99-ms MS [--slo-availability PCT] \
         [--autotune]] \
        [--continuous [--session-store N] [--idle-spill-ms MS] \
         [--session-slo-ms MS] [--session-ttl-ms MS] \
         [--session-store-addr HOST:PORT]] \
        [--replicas N|auto | --workers N|auto [--respawn-workers]]
    python -m paddle_tpu_torch.cli serve --model NAME=DIR[:PRIORITY] ... \
        [--replicas N|auto | --workers N|auto] [serve's other options]
    python -m paddle_tpu_torch.cli generate BUNDLE_DIR --prime 5,17,3 \
        [--steps 32] [--temperature 0] [--seed 0] [--json]
    python -m paddle_tpu_torch.cli analyze [--all | FILE ...] [--json]
    python -m paddle_tpu_torch.cli analyze --topology --config conf.py \
        [--buckets 25,50,100] [--steps-per-call 4] [--format json]

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

``export`` exports ``--builder``'s output layer or a ``--config``'s
``infer_outputs()`` (else ``cost()``); ``--params`` is a tar of either
package's ``Parameters.to_tar`` or an npz of ``Parameters.to_npz`` (a
JAX bundle's params.npz included), and without it the parameters are
initialised from ``--seed``. The programs are traced on the card (or
``--device cpu``) and serve on ``--platforms`` (default: that device's
type). ``--quantize int8`` writes a quantized bundle (serve/quantize.py),
which ``serve`` runs unchanged. ``--decode-slots`` adds the
continuous-batching decode step of a streamable topology, which ``serve
--continuous`` runs through the scheduler with its session tier and
``generate`` loops for streaming generation (serve/generate.py).
``serve`` and ``generate`` run on the card unless ``--device cpu``.
``serve --model`` hosts several bundles behind the router
(serve/router.py); ``--replicas`` serves each as engine threads
(serve/fleet.py), ``--workers`` as worker processes over shared memory
(serve/workers.py); ``--session-store-addr`` pages sessions to a remote
store process (serve/remote_store.py). SIGTERM stops a server as Ctrl-C
does: engines drain, workers stop, shared memory is unlinked.

``cluster_train`` launches ``--num-processes`` data-parallel workers on
this machine (distributed/launcher.py; the CPU under ``--device cpu``,
else the card: gloo where the ranks share one card, NCCL where each has
its own) and prints each worker's result; ``--devices-per-process k``
gives each worker k local devices (replicas sharing the cards where there
are fewer). ``--trainer-count N`` (the ``trainer_count`` flag, as in the
JAX package) trains over a DataParallel mesh of N local devices in this
one process, a replica and a thread each (the reference's
MultiGradientMachine); a count above the visible devices exits with the
JAX package's message, and ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES=N`` names N
replicas on the visible devices, as JAX's
``--xla_force_host_platform_device_count`` does. Inside a process group
of N ranks (distributed/multihost.py) it spans the ranks instead.
``observe --fleet-stats HOST:PORT`` adds
the coordinator's live leases to the summary.

``serve DIR --join COORD:PORT [--host-id H --lease-ttl S]`` makes the
server a host of a serving cluster, and ``serve --front --join
COORD:PORT [--rehome-retries N]`` runs the cluster's front over the
joined hosts (serve/cluster.py).

``merge_model`` fuses ``--builder``'s (with ``--builder-kwargs``) or a
``--config``'s model proto and a ``--params`` tar into one tar that the
C API (capi/) loads without running any user Python.

``analyze [--all | PATHS...] [--format json]`` lints the port's tree
(analyze/lint.py's nine checkers, read in PyTorch terms) and checks the
derived reject_packed coverage; ``analyze --topology --config conf.py
[--buckets 25,50,100] [--steps-per-call 4]`` reports the topology checks
and the programs (CUDA graph captures) the combination makes. Exit 0
clean, 1 on findings or topology errors, 2 for ``--topology`` without
``--config``, as in the JAX package.

``observe DIR --regress BASELINE.json [--regress-tol PCT]`` gates the
``bench_row`` records of DIR's step logs against the baseline's audited
rows (observe/regress.py) and exits 1 on a gated regression.
"""

import argparse
import contextlib
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


def _build(cfg, device=None, parallelism=None):
    """(cost, parameters, trainer) of a loaded config on ``device`` (the
    card unless "cpu"). ``--trainer-count N`` (the ``trainer_count``
    flag) makes the trainer data-parallel over N devices
    (paddle_tpu/cli.py:95-111): N local replicas of this process, which
    must not exceed the visible devices (``PADDLE_TPU_TORCH_VIRTUAL_DEVICES``
    names more); inside a process group, the group's N ranks."""
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils import flags

    tc = flags.get_flag("trainer_count") or 1
    if parallelism is None and tc > 1:
        from paddle_tpu_torch.parallel import mesh

        if mesh.world_size() > 1:
            n_dev = mesh.device_count()
            if tc > n_dev:
                raise SystemExit(
                    "--trainer-count %d exceeds the %d devices of the "
                    "process group's ranks" % (tc, n_dev))
            parallelism = mesh.DataParallel(mesh.build_mesh(
                {"data": tc}, devices=mesh.rank_devices(device)))
        else:
            local = mesh.local_devices(device=device)
            if tc > len(local):
                raise SystemExit(
                    "--trainer-count %d exceeds the %d visible devices "
                    "(set %s=N for N replicas on the visible devices)"
                    % (tc, len(local), mesh.VIRTUAL_DEVICES_ENV))
            parallelism = mesh.DataParallel(
                mesh.build_mesh({"data": tc}, devices=local[:tc]))
    cost = cfg.cost()
    params = Parameters.create(cost, device=device)
    optimizer = (cfg.optimizer() if hasattr(cfg, "optimizer")
                 else opt.Momentum(learning_rate=0.01, momentum=0.9))
    extra = list(cfg.evaluators()) if hasattr(cfg, "evaluators") else None
    trainer = SGD(cost, params, optimizer, extra_layers=extra, device=device,
                  parallelism=parallelism)
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
    feed = convert_feed(Topology(cost), batch, device=device)
    check_layer_grad(cost, feed, check_inputs=False, device=device)
    print("checkgrad PASSED")
    return 0


def cmd_cluster_train(args):
    """The cluster launcher job (reference scripts/cluster_train/paddle.py;
    paddle_tpu/cli.py cmd_cluster_train): ``--num-processes`` workers on
    this machine, each one rank of the data-parallel group; prints each
    worker's result line."""
    from paddle_tpu_torch.distributed.launcher import launch_local_cluster
    from paddle_tpu_torch.utils import flags

    if (flags.get_flag("trainer_count") or 1) > 1:
        raise SystemExit(
            "--trainer-count does not apply to cluster_train: every worker "
            "spans the whole process group; use --num-processes to set the "
            "parallel width")
    use_tpu = None
    if args.device:
        use_tpu = not args.device.startswith("cpu")
    results = launch_local_cluster(
        args.config, args.num_processes, num_passes=args.num_passes,
        batch_size=args.batch_size, config_args=args.config_args,
        devices_per_process=args.devices_per_process, use_tpu=use_tpu)
    for r in results:
        print(json.dumps(r))
    return 0


def cmd_analyze(args):
    """Framework-aware static analysis (paddle_tpu/cli.py cmd_analyze).

    Default/``--all``: lint the port's source tree (analyze/lint.py's nine
    checkers) AND verify the derived reject_packed coverage; exits 1 on
    any finding. With ``--topology --config cfg.py``: build the config's
    topology and run the pre-dispatch graph checks plus the program
    prediction for its reader/buckets/steps-per-call combination (no
    tracing, no device); exits 1 on topology errors, 2 without
    ``--config``. Arguments, output and exit codes are the JAX
    package's."""
    from paddle_tpu_torch.analyze import lint, topology_check

    if args.topology:
        if not args.config:
            print("analyze --topology needs --config", file=sys.stderr)
            return 2
        from paddle_tpu_torch import minibatch
        from paddle_tpu_torch.parameters import Parameters
        from paddle_tpu_torch.topology import Topology

        cfg = _load_config(args.config, args.config_args)
        cost = cfg.cost()
        params = Parameters.create(cost, device="cpu")
        topo = Topology(cost)
        report = topology_check.check_topology(
            topo, parameters=params,
            steps_per_call=args.steps_per_call or None)
        optimizer = (cfg.optimizer()
                     if hasattr(cfg, "optimizer") else None)
        report["hbm"] = topology_check.estimate_hbm_bytes(
            topo, parameters=params, optimizer=optimizer)
        buckets = ([int(b) for b in args.buckets.split(",") if b]
                   if args.buckets else None)
        if hasattr(cfg, "train_reader"):
            batch_size = getattr(cfg, "batch_size", args.batch_size)
            reader = minibatch.batch(cfg.train_reader(), batch_size)
            if args.sample_batches:
                import itertools

                base = reader
                reader = lambda: itertools.islice(  # noqa: E731
                    base(), args.sample_batches)
            report["jit_entries"] = topology_check.predict_jit_entries(
                topo, reader, buckets=buckets,
                steps_per_call=args.steps_per_call or None,
                parameters=params, optimizer=optimizer)
        if args.format == "json":
            print(json.dumps(report, indent=2))
        else:
            print(topology_check.format_report(report))
            if "jit_entries" in report:
                je = report["jit_entries"]
                print("jit entries: %d program(s), est. hbm peak %s"
                      % (je["programs"],
                         topology_check._fmt_bytes(je["hbm_peak_bytes"])))
                for e in je["entries"]:
                    print("  %(kind)s rows=%(rows)d" % e
                          + (" steps=%d" % e["steps"]
                             if e["kind"] == "scan" else "")
                          + (" pad=%s" % e["seq_pad"]
                             if e["seq_pad"] else "")
                          + " hbm=%s" % topology_check._fmt_bytes(
                              e["hbm"]["total"]))
        return 1 if report["errors"] else 0

    if args.paths:
        findings = lint.lint_paths(args.paths)
        n_files = len(args.paths)
    else:
        findings, n_files = lint.lint_tree()
    coverage = topology_check.verify_reject_packed_coverage()
    rc = 1 if (findings or coverage["missing"]) else 0
    if args.format == "json":
        # each finding record keeps the file/line/id/title/message/fixit
        # order (no sort_keys); findings are sorted by (file, line, id)
        print(json.dumps({
            "files": n_files,
            "checkers": sorted(lint.CHECKERS),
            "findings": [f.as_dict() for f in findings],
            "reject_packed": coverage}, indent=2))
        return rc
    for f in findings:
        print(lint.format_finding(f))
    for name in coverage["missing"]:
        print("reject_packed coverage gap: layer %r mixes across time "
              "positions but accepts packed input (derived set: %s)"
              % (name, coverage["expected"]))
    if rc == 0:
        print("analyze clean: %d files, %d checkers, reject_packed "
              "coverage %d/%d layers"
              % (n_files, len(lint.CHECKERS),
                 len(coverage["covered"]), len(coverage["expected"])))
    else:
        print("analyze: %d finding(s)" % (len(findings)
                                          + len(coverage["missing"])))
    return rc


def cmd_observe(args):
    """Summarize a telemetry directory (either package's): per-run step
    counts, steady-state wall-time p50/p95/p99, event totals, feed
    stalls, checkpoints, the training-fleet block (observe/trainview.py)
    and the trace files to open in Perfetto — the JAX package's report,
    line for line. ``--fleet-stats HOST:PORT`` adds the coordinator's live
    membership (``fleet_stats``: each lease's time to expiry) and its
    serving hosts. With ``--regress <baseline.json>`` the ``bench_row``
    records mirrored into the directory are gated against the audited
    baseline (observe/regress.py) and a gated regression exits 1."""
    from paddle_tpu_torch.observe import steplog

    summary = steplog.summarize_dir(args.directory)
    rc = 0
    regress_results = None
    if args.regress:
        import glob as _glob

        from paddle_tpu_torch.observe import regress as observe_regress

        rows = []
        for path in sorted(_glob.glob(
                os.path.join(args.directory, "*.steps.jsonl"))):
            rows.extend(r for r in steplog.read_jsonl(path)
                        if r.get("type") == "bench_row")
        results, regressions = observe_regress.gate_rows(
            rows, baseline_paths=[args.regress],
            base_tol_pct=args.regress_tol)
        regress_results = results
        if regressions:
            rc = 1
    if args.fleet_stats:
        # live membership next to the post-hoc file view; a short retry
        # window, so the query does not hang behind a dead coordinator
        from paddle_tpu_torch.distributed.client import CoordinatorClient

        client = CoordinatorClient(args.fleet_stats, worker_id="observe",
                                   retry_timeout=5.0)
        try:
            summary["fleet_stats"] = client.fleet_stats()
            summary["serve_hosts_live"] = client.serve_hosts()
        finally:
            client.close()
    if args.json:
        if regress_results is not None:
            summary["regress"] = regress_results
        print(json.dumps(summary, indent=2))
        return rc
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
    stats = summary.get("fleet_stats")
    if stats:
        ws = stats.get("workers", [])
        print("  live fleet (%s): %d worker(s)"
              % (args.fleet_stats, len(ws)))
        for w in ws:
            print("    %-12s lease remaining %.1fs"
                  % (w["id"], w["lease_remaining"]))
        hosts = summary.get("serve_hosts_live", {}).get("hosts", [])
        if hosts:
            print("  serving hosts: %d" % len(hosts))
            for h in hosts:
                print("    %-12s lease remaining %.1fs  %s"
                      % (h["id"], h["lease_remaining"],
                         h.get("meta", "")))
    if summary["trace_files"]:
        print("  traces (open in https://ui.perfetto.dev): %s"
              % ", ".join(summary["trace_files"]))
    if not summary["runs"]:
        print("  no *.steps.jsonl runs found")
    if regress_results is not None:
        from paddle_tpu_torch.observe.regress import format_result

        gated = [r for r in regress_results
                 if r["status"] == "regression"]
        print("  regression gate vs %s: %d row(s) checked, %d gated"
              % (args.regress, len(regress_results), len(gated)))
        for r in regress_results:
            if r["status"] in ("regression", "ok"):
                print("    " + format_result(r))
    return rc


def _export_outputs(args):
    """The output layer(s) ``cli export`` exports: ``--builder``'s
    function called with ``--builder-kwargs``, or a ``--config``'s
    ``infer_outputs()`` (else its ``cost()``), built with fresh name
    counters so layer and parameter names match a fresh process's."""
    from paddle_tpu_torch.graph import reset_name_counters

    reset_name_counters()
    if args.builder:
        module, _, function = args.builder.partition(":")
        enforce(module and function,
                "builder must be 'module.path:function', got %r",
                args.builder)
        fn = getattr(importlib.import_module(module), function)
        return fn(**json.loads(args.builder_kwargs))
    cfg = _load_config(args.config, args.config_args)
    return (getattr(cfg, "infer_outputs", None) or cfg.cost)()


def _export_params(args, outputs):
    """``--params``: a parameter tar (``Parameters.to_tar`` of either
    package) or an npz (``Parameters.to_npz``, a bundle's params.npz);
    without it the parameters are initialised from ``--seed``."""
    import tarfile

    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.parameters import Parameters

    device = resolve_device(args.device or None)
    if not args.params:
        return Parameters.create(outputs, seed=args.seed, device=device)
    if tarfile.is_tarfile(args.params):
        with open(args.params, "rb") as fh:
            return Parameters.from_tar(fh, device=device)
    return Parameters.from_npz(args.params, device=device)


def cmd_merge_model(args):
    """Fuse the model's ModelConfig proto and its parameters into ONE tar
    that the C API loads without running any user Python
    (paddle_tpu/cli.py ``cmd_merge_model``; reference paddle/trainer/
    MergeModel.cpp). Members as the JAX package writes them:
    ``merged_manifest.json`` (format ``paddle_tpu-merged-model-v1``),
    ``model.pb``, ``parameters.tar`` and the ``--config`` file where one
    was given. A ``--builder`` naming ``paddle_tpu.X`` builds with the
    port's ``paddle_tpu_torch.X``. Layers whose constructor arguments do
    not serialise are recorded opaque; such models load through the
    recorded builder (proto/interchange.py), which either package calls
    with no arguments, so ``--builder-kwargs`` other than ``{}`` are
    refused for them: bind the widths in a ``module:function`` of their
    own instead."""
    import io
    import tarfile

    from paddle_tpu_torch.capi.bridge import _run_builder
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.proto.interchange import opaque_layer_names
    from paddle_tpu_torch.topology import Topology

    builder_kwargs = json.loads(args.builder_kwargs or "{}")
    reset_name_counters()
    if args.builder:
        outputs = _run_builder(args.builder, builder_kwargs)
    elif args.config:
        cfg = _load_config(args.config, "")
        outputs = (getattr(cfg, "infer_outputs", None) or cfg.cost)()
    else:
        print("merge_model needs --builder or --config", file=sys.stderr)
        return 2
    msg = Topology(outputs).to_proto()
    opaque = opaque_layer_names(msg)
    if opaque and builder_kwargs:
        print("merge_model: layers %s are opaque, so the merged model loads "
              "through the builder, which the C API calls with no "
              "arguments; --builder-kwargs %s would be lost. Bind them in "
              "a 'module:function' of your own and pass that as --builder"
              % (",".join(opaque), json.dumps(builder_kwargs)),
              file=sys.stderr)
        return 2
    proto_bytes = msg.SerializeToString()

    with open(args.params, "rb") as f:
        payload = f.read()
    manifest = json.dumps({
        "format": "paddle_tpu-merged-model-v1",
        "builder": args.builder or "",
        "config_file": os.path.basename(args.config or ""),
        "opaque_layers": opaque,
    }).encode()
    with tarfile.open(args.output, "w") as tar:
        for name, data in (("merged_manifest.json", manifest),
                           ("model.pb", proto_bytes),
                           ("parameters.tar", payload)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        if args.config:
            tar.add(args.config, arcname=os.path.basename(args.config))
    if opaque:
        print("note: opaque layers (builder required at load): %s"
              % ",".join(opaque))
    print("merged model written to", args.output)
    return 0


def cmd_export(args):
    """Export a serving bundle (paddle_tpu/cli.py ``cmd_export``): one
    ``torch.export`` program per batch bucket, params.npz and the
    manifest; the bundle loads in a fresh process without running any
    model or config code. When the exporting device is among the
    bundle's platforms, the bundle is reloaded and run here first
    (``verify_bundle``)."""
    from paddle_tpu_torch.serve.export import export_bundle, verify_bundle

    if not (args.builder or args.config):
        print("export needs --builder or --config", file=sys.stderr)
        return 2
    outputs = _export_outputs(args)
    params = _export_params(args, outputs)
    manifest = export_bundle(
        outputs, params, args.output,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",") if b],
        seq_len=args.seq_len, name=args.name or None,
        platforms=args.platforms.split(",") if args.platforms else None,
        decode_slots=[int(n) for n in args.decode_slots.split(",") if n],
        decode_window=args.decode_window, quantize=args.quantize or None)
    device = next(iter(params.as_dict().values())).device
    if device.type in manifest["platforms"]:
        verify_bundle(args.output, device=device)
    summary = {"bundle": args.output, "name": manifest["name"],
               "buckets": [b["batch"] for b in manifest["buckets"]],
               "inputs": [i["name"] for i in manifest["inputs"]],
               "outputs": manifest["outputs"],
               "platforms": manifest["platforms"],
               "compute_dtype": manifest["compute_dtype"],
               "hbm_estimate_bytes": manifest["hbm_estimate_bytes"]}
    if manifest.get("quantization"):
        summary["quantization"] = manifest["quantization"]["scheme"]
    if manifest.get("decode"):
        summary["decode_slots"] = [b["slots"] for b in
                                   manifest["decode"]["slots"]]
        summary["decode_window"] = manifest["decode"]["window"]
    print(json.dumps(summary))
    return 0


def _session_kwargs(args):
    """The session tier's knobs of ``serve --continuous``
    (paddle_tpu/cli.py ``_session_kwargs``); ``--session-store-addr``
    pages against a shared remote store process instead of a private
    one (serve/remote_store.py)."""
    kw = {"session_capacity": args.session_store,
          "idle_spill_ms": args.idle_spill_ms,
          "session_slo_grace_ms": args.session_slo_ms,
          "session_ttl_ms": args.session_ttl_ms}
    if args.session_store_addr:
        from paddle_tpu_torch.serve.remote_store import RemoteSessionStore

        kw["session_store"] = RemoteSessionStore(args.session_store_addr)
    return kw


def _make_engine(bundle, args, reg=None, model=None, warmup="async",
                 budget_share=None, steplog=None):
    """The serving front of one bundle (paddle_tpu/cli.py
    ``_make_engine``): the batching engine, or with ``--continuous`` the
    continuous scheduler; ``--replicas N|auto`` makes it a fleet of engine
    threads (serve/fleet.py), ``--workers N|auto`` a fleet of worker
    processes (serve/workers.py). ``budget_share`` is this model's part of
    the device-memory budget for ``auto``; ``steplog`` is a joined host's
    own step log (a single engine writes there; a fleet keeps its
    per-member logs)."""
    from paddle_tpu_torch.serve import (ContinuousScheduler,
                                        InferenceEngine)
    from paddle_tpu_torch.serve.fleet import auto_replicas

    if args.continuous and not bundle.has_decoder():
        print("--continuous: bundle %r has no decode artifacts; "
              "re-export with --decode-slots" % bundle.name,
              file=sys.stderr)
        raise SystemExit(2)
    if args.workers and args.replicas:
        print("--workers (worker processes) and --replicas (in-process "
              "threads) are mutually exclusive: pick one data plane",
              file=sys.stderr)
        raise SystemExit(2)
    if args.workers and args.session_store_addr:
        # a store client holds a live socket, which cannot cross the
        # worker spawn; the worker protocol carries no dial-up of its own
        print("--session-store-addr cannot combine with --workers: "
              "use --replicas or a single engine per process",
              file=sys.stderr)
        raise SystemExit(2)
    kwargs = (dict({"max_queue": args.max_queue_rows},
                   **_session_kwargs(args)) if args.continuous
              else {"max_batch_size": args.max_batch_size,
                    "max_latency_ms": args.max_latency_ms,
                    "max_queue_rows": args.max_queue_rows})
    if args.workers:
        from paddle_tpu_torch.serve import WorkerSet

        # auto sizes as JAX's --replicas auto (each process holds its own
        # copy, so several may share a card), capped at the host's cores
        n = (min(auto_replicas(bundle, budget=budget_share, stack=True),
                 os.cpu_count() or 1)
             if args.workers == "auto" else int(args.workers))
        return WorkerSet(bundle, workers=max(n, 1),
                         continuous=args.continuous, engine_kwargs=kwargs,
                         metrics_registry=reg, model=model,
                         respawn=args.respawn_workers)
    if args.replicas:
        from paddle_tpu_torch.serve import ReplicaSet

        n = (auto_replicas(bundle, budget=budget_share)
             if args.replicas == "auto" else int(args.replicas))
        return ReplicaSet(bundle, replicas=n, continuous=args.continuous,
                          engine_kwargs=kwargs, metrics_registry=reg,
                          model=model, warmup=warmup)
    cls = ContinuousScheduler if args.continuous else InferenceEngine
    return cls(bundle, warmup=warmup, metrics_registry=reg, model=model,
               steplog=steplog, **kwargs)


def _make_slo(fronts, args, model=None):
    """The burn-rate SLO monitor over the serving fronts
    (paddle_tpu/cli.py ``_make_slo``): always built, so ``GET /debug/slo``
    answers; its evaluation thread (and the ``slo_status`` records) runs
    only when ``--slo-p99-ms`` / ``--slo-availability`` declared an
    objective."""
    from paddle_tpu_torch.observe import health as observe_health
    from paddle_tpu_torch.observe import metrics as observe_metrics
    from paddle_tpu_torch.observe import steplog

    slo = observe_health.SloMonitor(
        fronts, p99_ms=args.slo_p99_ms,
        availability=args.slo_availability,
        registry=observe_metrics.get_registry(),
        slog=steplog.from_env("slo", meta={"phase": "slo"}),
        model=model)
    if slo.active:
        slo.start()
    return slo


def _make_controller(slo, fronts, args, model=None):
    """With ``--autotune``, the controller over every knob the serving
    fronts register (paddle_tpu/cli.py ``_make_controller``); it needs a
    declared objective, else there is nothing to steer toward."""
    if not args.autotune:
        return None
    if not slo.active:
        print("--autotune needs a declared objective: add --slo-p99-ms "
              "(and optionally --slo-availability)", file=sys.stderr)
        raise SystemExit(2)
    from paddle_tpu_torch.control import Controller, KnobRegistry
    from paddle_tpu_torch.observe import metrics as observe_metrics
    from paddle_tpu_torch.observe import steplog

    knobs = KnobRegistry()
    for front in fronts:
        front.register_knobs(knobs)
    controller = Controller(
        slo, knobs, registry=observe_metrics.get_registry(),
        slog=steplog.from_env("control", meta={"phase": "control"}),
        model=model)
    controller.start()
    return controller


@contextlib.contextmanager
def _graceful_sigterm():
    """While serving, SIGTERM takes Ctrl-C's path: the ``finally`` blocks
    stop the engines and fleets (which drain, flush their step logs, stop
    their worker processes and unlink their shared memory). One-shot: a
    second SIGTERM during the drain must not abort it. The previous
    handler comes back on exit."""
    import signal

    def _term(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt

    try:
        previous = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread: keep the default
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, previous)


def cmd_serve(args):
    """Serve exported bundles (paddle_tpu/cli.py ``cmd_serve``). One
    model: ``serve DIR`` (``--continuous`` for decode bundles,
    ``--replicas`` / ``--workers`` for fleets). Several: repeat ``--model
    NAME=DIR[:PRIORITY]`` to host them behind the router (``POST
    /infer/<name>``, per-model ``/readyz``, priority shedding).
    ``--selfcheck`` loads, warms, runs one batch and exits. ``--join
    COORD:PORT`` makes this a host of a serving cluster (a lease whose
    meta carries its address, a step log of its own, ``GET
    /debug/compiles``); ``--front --join COORD:PORT`` runs the cluster's
    front instead of an engine (serve/cluster.py)."""
    with _graceful_sigterm():
        return _serve(args)


def _serve_front(args):
    """``serve --front --join COORD:PORT``: no bundle, no device; the
    hosts come from the coordinator's leases, a consistent-hash ring over
    them routes sessions, a lapsed lease re-homes them (paddle_tpu/cli.py
    ``cmd_serve``)."""
    from paddle_tpu_torch.observe import steplog
    from paddle_tpu_torch.serve.cluster import (ClusterFront,
                                                make_front_server)

    slog = steplog.from_env("serve-front", meta={"phase": "serve_front"})
    front = ClusterFront(endpoint=args.join, steplog=slog,
                         rehome_retries=args.rehome_retries)
    server = make_front_server(front, host=args.host, port=args.port)
    print("serving front on http://%s:%d over coordinator %s (POST "
          "/infer; GET /healthz /readyz /hosts /stats /metrics)"
          % (*server.server_address, args.join), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        front.stop()
        if slog is not None:
            slog.close()
    return 0


def _serve(args):
    from paddle_tpu_torch.observe import metrics as observe_metrics
    from paddle_tpu_torch.observe import steplog
    from paddle_tpu_torch.serve.bundle import load_bundle

    reg = observe_metrics.get_registry()
    if args.front:
        if args.bundle or args.model or args.selfcheck:
            print("--front holds no engine: drop the positional bundle / "
                  "--model / --selfcheck", file=sys.stderr)
            return 2
        if not args.join:
            print("--front needs --join COORD:PORT to discover hosts",
                  file=sys.stderr)
            return 2
        return _serve_front(args)
    if args.join and args.model:
        print("--join serves ONE bundle per host: the cluster front routes "
              "bare POST /infer, not per-model paths", file=sys.stderr)
        return 2
    if args.model:
        if args.bundle or args.selfcheck:
            print("--model is multi-model mode: drop the positional "
                  "bundle / --selfcheck", file=sys.stderr)
            return 2
        return _serve_models(args, reg)
    if not args.bundle:
        print("serve needs a bundle directory or --model entries",
              file=sys.stderr)
        return 2
    bundle = load_bundle(args.bundle, device=args.device or None)
    if args.continuous and not bundle.has_decoder():
        # refuse loudly: a silent fall-back to the padding engine would
        # leave the operator believing continuous batching is active
        print("--continuous: bundle %r has no decode artifacts; "
              "re-export with --decode-slots" % bundle.name,
              file=sys.stderr)
        return 2
    if args.join and not args.selfcheck:
        # the counter behind GET /debug/compiles: the warmup's programs
        # count too, the drill reads its change across a host's death
        with steplog.watch_compiles() as watcher:
            return _serve_one(args, reg, bundle, watcher)
    return _serve_one(args, reg, bundle, None)


def _serve_one(args, reg, bundle, watcher):
    """One bundle behind its engine or fleet; with ``--join`` a host of a
    serving cluster: one step log of its own (``serve@<host id>``, the
    host in its meta line, so ``cli observe`` merges the hosts' files
    into one timeline), ``GET /debug/compiles`` from ``watcher``, the
    process's kernel launch counters in ``GET /stats``, and the lease
    started only after the server bound, so the address it announces
    already answers."""
    from paddle_tpu_torch.observe import steplog
    from paddle_tpu_torch.serve.server import make_server

    host_slog, host_id = None, ""
    if watcher is not None:
        import socket

        host_id = args.host_id or "%s-%d" % (socket.gethostname(),
                                             os.getpid())
        host_slog = steplog.from_env("serve@%s" % host_id,
                                     meta={"phase": "serve",
                                           "host": host_id})
    # selfcheck warms synchronously (it IS the warmth gate); serving warms
    # on a thread so /readyz honestly answers 503 until every bucket ran
    engine = _make_engine(bundle, args, reg,
                          warmup=True if args.selfcheck else "async",
                          steplog=host_slog)
    slo = controller = heartbeat = None
    try:
        if args.selfcheck:
            if hasattr(engine, "wait_ready"):
                # worker processes warm in themselves
                engine.wait_ready(timeout=300.0)
            out = engine.infer(bundle.dummy_inputs(rows=1), timeout=300.0)
            print(json.dumps({
                "ok": True, "bundle": bundle.name,
                "device": str(bundle.device),
                "buckets": bundle.batch_sizes(),
                "outputs": {k: list(v.shape) for k, v in out.items()},
                "stats": {k: v for k, v in engine.stats().items()
                          if isinstance(v, int)}}))
            return 0
        slo = _make_slo([engine], args, model=bundle.name)
        controller = _make_controller(slo, [engine], args,
                                      model=bundle.name)
        launches_fn = None
        if watcher is not None:
            from paddle_tpu_torch.serve.workers import kernel_launches

            launches_fn = kernel_launches
        server = make_server(
            bundle, engine, host=args.host, port=args.port, slo=slo,
            controller=controller,
            compiles_fn=None if watcher is None else (
                lambda: watcher.compiles),
            launches_fn=launches_fn)
        if watcher is not None:
            from paddle_tpu_torch.distributed.client import encode_host_meta
            from paddle_tpu_torch.distributed.elastic import HeartbeatThread

            heartbeat = HeartbeatThread(
                args.join, worker_id=host_id, ttl=args.lease_ttl,
                steplog=host_slog,
                meta=encode_host_meta(kind="serve", addr="%s:%d"
                                      % server.server_address[:2]))
            heartbeat.start()
        print("serving %r on http://%s:%d (POST /infer; GET /healthz "
              "/livez /readyz /metrics /stats /debug/traces /debug/slo%s%s "
              "/manifest)%s"
              % (bundle.name, *server.server_address[:2],
                 " /debug/control" if controller else "",
                 " /debug/compiles" if watcher is not None else "",
                 (" joined %s as %r" % (args.join, host_id))
                 if watcher is not None else ""), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        if controller is not None:
            controller.stop()
        if slo is not None:
            slo.stop(close_slog=True)
        engine.stop()
        if host_slog is not None:
            host_slog.close()


def _serve_models(args, reg):
    """``serve --model NAME=DIR[:PRIORITY] ...``: every bundle behind the
    router; with ``--replicas auto`` each model's fleet is sized against
    its share of the device-memory budget."""
    from paddle_tpu_torch.serve import Router
    from paddle_tpu_torch.serve.bundle import load_bundle
    from paddle_tpu_torch.serve.server import make_router_server

    specs = []
    for spec in args.model:
        name, _, rest = spec.partition("=")
        if not rest:
            print("--model wants NAME=DIR[:PRIORITY], got %r" % spec,
                  file=sys.stderr)
            return 2
        directory, _, priority = rest.rpartition(":")
        if not directory:  # no priority suffix
            directory, priority = rest, "normal"
        specs.append((name, directory, priority or "normal"))
    budget_share = None
    if args.replicas == "auto" and len(specs) > 1:
        from paddle_tpu_torch.analyze.topology_check import hbm_budget_bytes

        budget = hbm_budget_bytes()
        if budget is not None:
            budget_share = budget // len(specs)
    router = Router(metrics_registry=reg)
    slo = controller = server = None
    try:
        for name, directory, priority in specs:
            bundle = load_bundle(directory, device=args.device or None)
            router.add_model(name, bundle,
                             _make_engine(bundle, args, reg, model=name,
                                          budget_share=budget_share),
                             priority=priority)
        fronts = [m.engine for m in router.models().values()]
        slo = _make_slo(fronts, args)
        controller = _make_controller(slo, [router] + fronts, args)
        server = make_router_server(router, host=args.host, port=args.port,
                                    slo=slo, controller=controller)
        print("serving %s on http://%s:%d (POST /infer/<model>; GET "
              "/healthz /readyz /metrics /stats /debug/traces /debug/slo%s "
              "/manifest/<model>)"
              % (sorted(router.models()), *server.server_address,
                 " /debug/control" if controller else ""), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        if server is not None:
            server.server_close()
        if controller is not None:
            controller.stop()
        if slo is not None:
            slo.stop(close_slog=True)
        router.stop()


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
                             "--trainer_count): local replicas of this "
                             "process, a thread each (the ranks of the "
                             "process group where one is up)")
    common.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    common.add_argument("--use-tpu", action="store_true", default=None,
                        help="the JAX package's option: run on the card "
                             "(the default; refused with --device cpu)")

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
    p.add_argument("--regress", default="",
                   help="audited baseline JSON (a BENCH_*.json driver "
                        "record or a bench-row lines file); gates the "
                        "dir's bench_row records and exits non-zero on "
                        "a gated regression (observe/regress.py)")
    p.add_argument("--regress-tol", type=float, default=10.0,
                   help="base tolerance %% before the row's own "
                        "spread_pct widens it")
    p.add_argument("--fleet-stats", default="", metavar="HOST:PORT",
                   help="also query the coordinator at HOST:PORT for its "
                        "live membership (per-lease time to expiry)")
    p.set_defaults(fn=cmd_observe)

    p = sub.add_parser("checkgrad", parents=[common])
    p.set_defaults(fn=cmd_checkgrad)

    p = sub.add_parser("cluster_train", parents=[common])
    p.add_argument("--num-processes", type=int, required=True,
                   help="worker processes (one rank each)")
    p.add_argument("--num-passes", type=int, default=1)
    p.add_argument("--devices-per-process", type=int, default=None,
                   help="local devices per worker, a replica each "
                        "(default 1)")
    p.set_defaults(fn=cmd_cluster_train)

    p = sub.add_parser("merge_model",
                       help="fuse the model proto and its parameters "
                            "into one tar")
    p.add_argument("--config", default="",
                   help="config whose infer_outputs() (else cost()) is "
                        "merged")
    p.add_argument("--builder", default="",
                   help="module.path:function returning the output layer")
    p.add_argument("--builder-kwargs", default="{}",
                   help="JSON object of keyword arguments for the builder "
                        "(refused when the model has opaque layers)")
    p.add_argument("--params", required=True,
                   help="parameter tar (Parameters.to_tar) of either "
                        "package")
    p.add_argument("-o", "--output", required=True,
                   help="merged tar to write")
    p.set_defaults(fn=cmd_merge_model)

    p = sub.add_parser("analyze",
                       help="static analysis: lint the port's tree, or "
                            "check a config's topology")
    p.add_argument("paths", nargs="*",
                   help="explicit files to lint (default: the installed "
                        "paddle_tpu_torch tree)")
    p.add_argument("--all", action="store_true",
                   help="full static-analysis gate (lint + reject_packed "
                        "coverage; the default behavior, spelled out for "
                        "the CI one-liner)")
    p.add_argument("--topology", action="store_true",
                   help="pre-dispatch topology checks + the programs "
                        "(CUDA graph captures) --config will make")
    p.add_argument("--config", default="")
    p.add_argument("--config-args", default="")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--buckets", default="",
                   help="comma-separated bucket boundaries for the "
                        "program prediction")
    p.add_argument("--steps-per-call", type=int, default=0)
    p.add_argument("--sample-batches", type=int, default=64,
                   help="how many reader batches the program prediction "
                        "simulates")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="json = machine-readable findings (file/line/id/"
                        "message/fixit, stable ordering) for CI PR "
                        "annotation")
    p.add_argument("--json", dest="format", action="store_const",
                   const="json", help="alias for --format=json")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("export", help="write a serving bundle")
    p.add_argument("--config", default="",
                   help="config whose infer_outputs() (else cost()) is "
                        "exported")
    p.add_argument("--builder", default="",
                   help="module.path:function returning the output layer")
    p.add_argument("--config-args", default="",
                   help="k=v,... passed to the --config")
    p.add_argument("--builder-kwargs", default="{}",
                   help="JSON object of keyword arguments for the builder")
    p.add_argument("--params", default="",
                   help="parameter tar (Parameters.to_tar) or npz "
                        "(Parameters.to_npz) of either package")
    p.add_argument("--seed", type=int, default=0,
                   help="initialisation seed when --params is not given")
    p.add_argument("--device", default="",
                   help="torch device the parameters load on and the "
                        "programs are traced on (default: the card)")
    p.add_argument("-o", "--output", required=True,
                   help="bundle directory to write")
    p.add_argument("--batch-sizes", default="1,8,32",
                   help="comma-separated batch buckets")
    p.add_argument("--seq-len", type=int, default=None,
                   help="padded time dim for sequence inputs (default 64)")
    p.add_argument("--name", default="")
    p.add_argument("--platforms", default="",
                   help="comma-separated torch device types the bundle "
                        "serves on (cpu,cuda; default: --device's)")
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

    p = sub.add_parser("serve", help="serve bundles over HTTP")
    p.add_argument("bundle", nargs="?", default="",
                   help="bundle directory (one model)")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=DIR[:PRIORITY]",
                   help="host NAME from bundle DIR with an optional priority "
                        "class (high/normal/low); repeat to serve several "
                        "models behind the router (POST /infer/<name>, "
                        "per-model /readyz, priority shedding)")
    p.add_argument("--replicas", default="",
                   help="N|auto: serve each bundle as N engine threads "
                        "behind a least-queued dispatch front, cycled over "
                        "the cards (auto: one per card, fewer when the "
                        "manifest's hbm_estimate_bytes fits fewer copies "
                        "in PADDLE_TPU_TORCH_HBM_BUDGET)")
    p.add_argument("--workers", default="",
                   help="N|auto: serve each bundle as N worker processes "
                        "(spawned; rows cross over shared-memory rings; "
                        "exclusive with --replicas); auto: one per card, "
                        "or as many copies as the budget fits, capped at "
                        "the host's cores")
    p.add_argument("--respawn-workers", action="store_true",
                   help="--workers: restart a dead worker process in place "
                        "(its sessions re-home from their last committed "
                        "carry backup)")
    p.add_argument("--selfcheck", action="store_true",
                   help="load, warm, run one batch, exit (smoke gate)")
    p.add_argument("--device", default="",
                   help="torch device (default: the card)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8866)
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--max-latency-ms", type=float, default=5.0)
    p.add_argument("--max-queue-rows", type=int, default=None,
                   help="bound the queue; a full queue answers 429 "
                        "instead of queueing (load shedding)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="declare a p99 latency objective: the burn-rate "
                        "SLO monitor evaluates the health history against "
                        "it (GET /debug/slo, paddle_tpu_slo_* gauges, "
                        "slo_status step-log records on transitions)")
    p.add_argument("--slo-availability", type=float, default=None,
                   help="availability objective in percent (default 99.0 "
                        "with --slo-p99-ms): shed or over-objective "
                        "requests burn the error budget")
    p.add_argument("--autotune", action="store_true",
                   help="close the SLO loop: a controller thread moves the "
                        "registered serving knobs (deadline, queue bound, "
                        "spill thresholds) on the burn-rate verdicts, with "
                        "hysteresis, cooldowns and a rollback guard; every "
                        "move is a control_action record, a "
                        "paddle_tpu_control_* metric and a GET "
                        "/debug/control entry. Needs --slo-p99-ms")
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
                   help="--continuous: page sessions to the remote store "
                        "process (python -m "
                        "paddle_tpu_torch.serve.remote_store) instead of a "
                        "private store, so committed sessions survive this "
                        "process and resume bitwise in another")
    p.add_argument("--join", default="", metavar="COORD:PORT",
                   help="multi-host serving: register this host with the "
                        "coordinator under a TTL heartbeat lease whose "
                        "meta publishes its dial address; a front started "
                        "with --front routes to it while the lease holds")
    p.add_argument("--host-id", default="",
                   help="--join: stable host identity on the hash ring "
                        "(default hostname-pid); keep it across restarts "
                        "so a rejoining host reclaims its ring arcs")
    p.add_argument("--lease-ttl", type=float, default=10.0,
                   help="--join: coordinator lease TTL in seconds, the "
                        "failure-detection horizon; a host silent this "
                        "long is excluded from routing")
    p.add_argument("--front", action="store_true",
                   help="run the fleet-of-fleets front instead of an "
                        "engine: no bundle, no device; only sockets, the "
                        "consistent-hash ring over the hosts joined via "
                        "--join's coordinator, and routing state (session "
                        "affinity, re-home on lease lapse, shed reason "
                        "no_host)")
    p.add_argument("--rehome-retries", type=int, default=2,
                   help="--front: extra hosts tried after the ring home "
                        "fails before the request errors out")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    if getattr(args, "use_tpu", None):
        if (args.device or "").startswith("cpu"):
            parser.error("--use-tpu asks for the card and --device %s for "
                         "the CPU: give one of them" % args.device)
        if args.fn is not cmd_cluster_train:
            # the launcher's parent does not touch the card (its workers do)
            import paddle_tpu_torch as paddle

            paddle.init(use_tpu=True)
    if getattr(args, "trainer_count", None):
        from paddle_tpu_torch.utils import flags

        flags.set_flag("trainer_count", args.trainer_count)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
