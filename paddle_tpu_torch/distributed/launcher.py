"""Cluster launcher: start an N-process data-parallel training job on this
machine (paddle_tpu/distributed/launcher.py).

Reference parity: paddle/scripts/cluster_train/paddle.py, the fabric
script that started pservers and trainers across hosts with trainer_id
and ports wired up. There are no parameter servers to start (gradients
are summed with torch.distributed collectives): the launcher spawns one
worker (distributed/worker.py) per rank, points them all at rank 0's
store, and collects their results.

For several hosts, run ``python -m paddle_tpu_torch.distributed.worker``
on each with ``--coordinator`` pointing at rank 0's host (the worker is a
plain argv program).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local_cluster(config, num_processes, num_passes=1,
                         batch_size=None, config_args="", env=None,
                         timeout=900, devices_per_process=None,
                         use_tpu=None):
    """Spawn ``num_processes`` workers on localhost and wait.

    ``use_tpu``: True the card, False the CPU, None the workers' default
    (the card). ``devices_per_process=k`` (default 1): each worker trains
    k local replicas (``--devices-per-process``), on its own cards where
    the machine has them and sharing them where it has fewer, as the JAX
    package gives each process k virtual devices. Returns the list of
    per-worker result dicts (CLUSTER_RESULT lines). Raises RuntimeError
    if any worker fails, or if the workers disagree on the final cost
    (synchronous data parallelism keeps every rank's cost the same, bit
    for bit)."""
    port = _free_port()
    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    path = base_env.get("PYTHONPATH", "")
    base_env["PYTHONPATH"] = _REPO + (os.pathsep + path if path else "")
    workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_cluster_")
    procs = []
    streams = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.worker",
               "--config", str(config), "--process-id", str(pid),
               "--num-processes", str(num_processes),
               "--coordinator", "127.0.0.1:%d" % port,
               "--num-passes", str(num_passes)]
        if batch_size:
            cmd += ["--batch-size", str(batch_size)]
        if config_args:
            cmd += ["--config-args", config_args]
        if devices_per_process is not None:
            cmd += ["--devices-per-process", str(int(devices_per_process))]
        if use_tpu is not None:
            cmd += ["--use-tpu" if use_tpu else "--no-use-tpu"]
        # log FILES, not pipes: a chatty worker fills a 64 KB pipe buffer
        # and blocks long before the launcher drains it
        out_f = open(os.path.join(workdir, "worker%d.out" % pid), "w+")
        err_f = open(os.path.join(workdir, "worker%d.err" % pid), "w+")
        streams.append((out_f, err_f))
        procs.append(subprocess.Popen(cmd, stdout=out_f, stderr=err_f,
                                      text=True, env=base_env))

    def read_stream(f):
        f.flush()
        f.seek(0)
        return f.read()

    try:
        # poll ALL workers: one crashed worker leaves its siblings blocked
        # in a collective; awaiting them in turn would spend the whole
        # timeout on an innocent one and report it as the failure
        deadline = time.time() + timeout
        errors = []
        pending = dict(enumerate(procs))
        while pending and time.time() < deadline and not errors:
            for pid in list(pending):
                proc = pending[pid]
                if proc.poll() is None:
                    continue
                del pending[pid]
                if proc.returncode != 0:
                    errors.append("worker %d rc=%d: %s"
                                  % (pid, proc.returncode,
                                     read_stream(streams[pid][1])[-1500:]))
            time.sleep(0.2)
        if pending:
            sibling_failed = bool(errors)
            for pid, proc in pending.items():
                proc.kill()
                proc.wait()
                errors.append("worker %d %s" % (
                    pid, "killed (sibling failed)" if sibling_failed
                    else "timed out"))
        if errors:
            raise RuntimeError("cluster launch failed: %s (logs: %s)"
                               % ("; ".join(errors), workdir))
        results = []
        for pid in range(num_processes):
            out = read_stream(streams[pid][0])
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("CLUSTER_RESULT ")]
            if not lines:
                raise RuntimeError("worker %d printed no result (logs: %s)"
                                   % (pid, workdir))
            results.append(json.loads(lines[-1][len("CLUSTER_RESULT "):]))
        if any(r["final_cost"] is None for r in results):
            raise RuntimeError(
                "a worker trained zero batches (reader shorter than one "
                "batch?): %s (logs: %s)" % (results, workdir))
        finals = {r["final_cost"] for r in results}
        if len(finals) != 1:
            raise RuntimeError(
                "workers disagree on the final cost (the lockstep of "
                "synchronous data parallelism is broken): %s (logs: %s)"
                % (sorted(finals), workdir))
    except BaseException:
        for out_f, err_f in streams:  # close, but KEEP the logs
            out_f.close()
            err_f.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        raise
    for out_f, err_f in streams:
        out_f.close()
        err_f.close()
    shutil.rmtree(workdir, ignore_errors=True)  # logs kept only on failure
    return results
