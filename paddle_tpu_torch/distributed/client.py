"""Python client for the C++ coordinator (paddle_tpu/distributed/client.py;
reference go/master/client.go).

The trainer pulls task chunks from the coordinator instead of iterating a
local dataset: workers can die and rejoin, tasks time out and requeue,
poison tasks are dropped after failure_max (reference go/master
client.go:111-231 and the task lifecycle of service.go).

The coordinator is the JAX package's service, copied to
``coordinator/coordinator.cc`` (the same newline-JSON wire protocol, so
either package's client talks to either package's binary). It is built
at first use with ``g++ -O2 -std=c++17 -pthread`` into
``paddle_tpu_torch/build/`` under a name that carries a hash of the
source, as ops/_build.py builds the CUDA kernels.
"""

import hashlib
import json
import os
import selectors
import shutil
import socket
import subprocess
import threading
import time

from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORDINATOR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "coordinator", "coordinator.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")

_build_lock = threading.Lock()


def coordinator_binary():
    """The coordinator's path under ``build/``, named by a hash of its
    source and flags (an edited source builds anew)."""
    digest = hashlib.sha256()
    with open(COORDINATOR_SRC, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, "coordinator-%s" % digest.hexdigest()[:12])


def build_coordinator():
    """Compile the coordinator unless it is built already; returns its
    path. Raises with the compiler's output when the build fails."""
    out = coordinator_binary()
    with _build_lock:
        if os.path.isfile(out):
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, COORDINATOR_SRC],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        enforce(proc.returncode == 0,
                "coordinator build failed (%s exit %d):\n%s", cxx,
                proc.returncode, proc.stdout)
        os.replace(tmp, out)  # atomic: another process never runs half
    return out


def spawn_coordinator(port, snapshot_path="", task_timeout=600.0,
                      failure_max=3, build_if_missing=True):
    """Start a coordinator subprocess on localhost; returns the Popen."""
    binary = coordinator_binary()
    if not os.path.exists(binary):
        enforce(build_if_missing, "the coordinator is not built (%s)",
                binary)
        binary = build_coordinator()
    proc = subprocess.Popen(
        [binary, str(port), snapshot_path, str(task_timeout),
         str(failure_max)],
        stderr=subprocess.PIPE)
    # wait for the listening line. The RAW fd is polled and split here: a
    # buffered readline() lost "listening" when the recovery path wrote
    # "recovered\nlistening\n" in one chunk (readline returned the first
    # line, the second sat in Python's buffer, and select() on the fd
    # never fired again)
    fd = proc.stderr.fileno()
    sel = selectors.DefaultSelector()
    sel.register(fd, selectors.EVENT_READ)
    # generous: a loaded host can starve a fresh subprocess for a while
    deadline = time.time() + 180
    buf = b""
    try:
        while time.time() < deadline:
            if not sel.select(timeout=max(0.0, deadline - time.time())):
                break  # deadline hit with no output
            chunk = os.read(fd, 4096)
            if chunk == b"":  # EOF: the process died
                raise RuntimeError(
                    "coordinator failed to start on port %d (exit %s): %s"
                    % (port, proc.poll(), buf.decode(errors="replace")[-500:]))
            buf += chunk
            if b"listening" in buf:
                return proc
            # other lines (e.g. "recovered") just precede "listening"
    finally:
        sel.close()
    proc.kill()
    raise RuntimeError("coordinator did not start within 180s")


def spawn_coordinator_on_free_port(snapshot_path="", task_timeout=600.0,
                                   failure_max=3, retries=5):
    """Pick a free localhost port and spawn a coordinator on it, retrying
    on the (inherently racy) probe-then-bind window. Returns (port,
    Popen)."""
    last_err = None
    for _ in range(retries):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        try:
            return port, spawn_coordinator(
                port, snapshot_path=snapshot_path, task_timeout=task_timeout,
                failure_max=failure_max)
        except RuntimeError as e:
            # only the probe-then-bind race (the process exits at startup)
            # is worth retrying; a wedged binary surfaces at once
            if "failed to start" not in str(e):
                raise
            last_err = e
    raise last_err


def encode_host_meta(**fields):
    """Flat ``k=v,k=v`` metadata string for :meth:`CoordinatorClient
    .register`, quote-free so it passes through the coordinator's flat
    JSON parser verbatim."""
    for key, value in fields.items():
        if any(c in "=,\"" for c in "%s%s" % (key, value)):
            raise ValueError("host meta fields must not contain '=', "
                             "',' or quotes: %r=%r" % (key, value))
    return ",".join("%s=%s" % (k, v) for k, v in sorted(fields.items()))


def decode_host_meta(meta):
    """Inverse of :func:`encode_host_meta`; a field without ``=`` is
    skipped, so one bad host cannot wedge a membership poll."""
    out = {}
    for part in (meta or "").split(","):
        key, eq, value = part.partition("=")
        if eq:
            out[key.strip()] = value.strip()
    return out


class CoordinatorClient:
    """One worker's RPC handle. NOT thread-safe (one socket and read
    buffer): a background thread (elastic.HeartbeatThread) owns its own
    client over the same endpoint and worker id.

    ``retry_timeout``/``retry_max_delay``: transport failures retry with
    capped exponential backoff until the deadline, so a coordinator
    restart (its snapshot/recover path takes a few seconds) is invisible
    to workers instead of an exception."""

    def __init__(self, endpoint, worker_id=None, timeout=10.0,
                 retry_timeout=30.0, retry_max_delay=2.0):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self.addr = (host, int(port))
        self.worker_id = worker_id or "worker-%d" % os.getpid()
        self.timeout = timeout
        self.retry_timeout = float(retry_timeout)
        self.retry_max_delay = float(retry_max_delay)
        self._sock = None
        self._buf = b""

    # -- wire ---------------------------------------------------------------
    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._buf = b""

    def call(self, op, **kwargs):
        """One newline-JSON RPC round trip. Safe to retry across a
        coordinator restart: every op is lease- or queue-idempotent (a
        replayed get_task hands out a fresh lease; a replayed
        task_finished on a done task is a no-op)."""
        req = {"op": op, "worker": self.worker_id}
        req.update(kwargs)
        payload = (json.dumps(req) + "\n").encode()
        deadline = time.time() + self.retry_timeout
        delay = 0.05
        while True:
            try:
                self._connect()
                self._sock.sendall(payload)
                while b"\n" not in self._buf:
                    chunk = self._sock.recv(65536)
                    if not chunk:
                        raise ConnectionError("coordinator closed connection")
                    self._buf += chunk
                line, self._buf = self._buf.split(b"\n", 1)
                return json.loads(line)
            except (OSError, ConnectionError, json.JSONDecodeError) as exc:
                self.close()
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise
                logger.debug("coordinator rpc %s failed (%s); retrying for "
                             "another %.1fs", op, exc, remaining)
                time.sleep(min(delay, remaining))
                delay = min(delay * 2.0, self.retry_max_delay)

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- API ----------------------------------------------------------------
    def set_dataset(self, chunks, chunks_per_task=None):
        per = chunks_per_task or flags.get_flag("num_shards_per_task")
        return self.call("set_dataset", chunks=list(chunks),
                         chunks_per_task=per)

    def get_task(self, pass_id=None):
        """Returns (task_id, chunks), "retry" (all tasks pending on other
        workers), "pass_done" (the requested pass rolled over), or None
        (no dataset)."""
        kwargs = {} if pass_id is None else {"pass": pass_id}
        resp = self.call("get_task", **kwargs)
        if not resp.get("ok"):
            if resp.get("retry"):
                return "retry"
            if resp.get("error") == "pass done":
                return "pass_done"
            return None
        return resp["task_id"], resp["chunks"]

    def task_finished(self, task_id):
        return self.call("task_finished", task_id=task_id)

    def task_failed(self, task_id):
        return self.call("task_failed", task_id=task_id)

    def register(self, ttl=30.0, meta=None):
        """``meta=`` is an optional flat metadata string attached to this
        worker's membership entry (:func:`encode_host_meta`); the
        coordinator republishes it through ``serve_hosts`` and drops it
        with the lease."""
        if meta:
            return self.call("register", ttl=ttl, meta=meta)
        return self.call("register", ttl=ttl)

    def heartbeat(self, ttl=30.0, meta=None):
        if meta:
            return self.call("heartbeat", ttl=ttl, meta=meta)
        return self.call("heartbeat", ttl=ttl)

    def workers(self):
        return self.call("workers").get("workers", [])

    def fleet_stats(self):
        """Live membership with per-lease time-to-expiry: ``{"now":
        <coordinator clock>, "workers": [{"id", "lease_remaining"},
        ...]}``, what ``cli observe --fleet-stats`` prints (a negative
        lease_remaining: lapsed, not yet swept)."""
        return self.call("fleet_stats")

    def serve_hosts(self):
        """The workers registered WITH metadata: ``{"now": ..., "hosts":
        [{"id", "lease_remaining", "meta"}, ...]}``."""
        return self.call("serve_hosts")

    def request_save_model(self, ttl=60.0):
        """True iff this worker wins the save election (exactly one does
        per ttl window; reference RequestSaveModel)."""
        return bool(self.call("request_save_model", ttl=ttl).get("elected"))

    def status(self):
        return self.call("status")

    # -- reader integration --------------------------------------------------
    def task_reader(self, chunk_to_samples, max_retries=1000):
        """A reader() pulling tasks until the pass drains.
        ``chunk_to_samples(chunk) -> iterable of samples`` loads one chunk.
        A failure inside a task reports task_failed, so the chunk requeues
        elsewhere."""

        def reader():
            # one reader() iteration == one pass over the dataset
            pass_id = self.status().get("pass", 0)
            retries = 0
            while True:
                task = self.get_task(pass_id=pass_id)
                if task is None or task == "pass_done":
                    return
                if task == "retry":
                    retries += 1
                    if retries > max_retries:
                        return
                    time.sleep(0.1)
                    continue
                retries = 0  # only *consecutive* retries give up
                task_id, chunks = task
                try:
                    for chunk in chunks:
                        for sample in chunk_to_samples(chunk):
                            yield sample
                except Exception:
                    logger.exception("task %s failed; reporting", task_id)
                    self.task_failed(task_id)
                    continue
                self.task_finished(task_id)

        return reader
