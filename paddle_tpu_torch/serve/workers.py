"""Multi-process serving data plane: each replica as its own worker
PROCESS behind the fleet front door (paddle_tpu/serve/workers.py).

:class:`~paddle_tpu_torch.serve.fleet.ReplicaSet` runs its engines as
threads of one interpreter; :class:`WorkerSet` runs each in a process of
its own:

* each worker is **spawned** (never forked: the parent may hold a live
  CUDA context) with nothing but the bundle directory and a device string
  in its arguments. It imports the kernel modules (which register the
  ``torch.ops.paddle_tpu_torch.*`` ops the programs call) through
  :func:`~paddle_tpu_torch.serve.bundle.load_bundle`, loads the bundle on
  its device (``cuda:{i % count}`` when the parent's bundle is on a card,
  ``cpu`` when it is on the CPU) and builds an ordinary engine or
  continuous scheduler with ``{replica=}`` labels and its own step log
  ``<run>-w<i>``;
* the parent holds only sockets, queues and routing state: the same
  least-queued and consistent-hash session dispatch as ``ReplicaSet``,
  duck-typed like an engine, so the router and the HTTP front door host a
  ``WorkerSet`` unchanged;
* requests and answers cross over a **shared-memory ring** per direction
  (:class:`ShmRing`): fixed slots sized from the manifest's buckets, a
  state word per slot written last on publish, busy-poll then a wait on
  a semaphore doorbell. Rows are raw array bytes beside a small JSON
  header: one copy in, one copy out, nothing pickled;
* control traffic (readiness, stats, metric snapshots, session export and
  import, stop, heartbeat) rides a pipe RPC (:class:`_Rpc`) with the same
  codec. Every call carries a sequence number that its reply echoes, so a
  reply that comes after its caller timed out (a worker still loading its
  bundle) is dropped instead of answering the next call.

Failure model: a worker killed ``-9`` is found by ``Process.is_alive`` or
by three missed heartbeats once it first answered; it leaves dispatch, the
answers it already published are read out, its in-flight requests are
re-routed, and its sessions re-home from the **committed carry backup**
the parent takes after every completed session chunk (export then
re-import inside the worker), so a conversation resumes bitwise from its
last acknowledged chunk. ``respawn=True`` starts a replacement in the
slot.

Shutdown leaks nothing: ``stop()`` drains, stops each worker over RPC,
joins it against a deadline (then terminate, then kill), closes and
unlinks every segment; an ``atexit`` sweep covers the parent's crash
path.

The worker's ``stats`` reply also carries its process's pid and kernel
launch counters (``kernel_launches``): launches made in another process
are invisible to the parent's counters.
"""

import atexit
import collections
import itertools
import json
import os
import struct
import threading
import time
import weakref
from concurrent.futures import Future
from multiprocessing import shared_memory

import numpy as np
import torch

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.serve.engine import Overloaded
from paddle_tpu_torch.serve.sessions import (ConsistentHashRing, SessionGone,
                                             SessionState)

# the session -> worker table is a routing hint (the carries live in the
# workers), bounded as in serve/fleet.py
_SESSION_HOME_CAP = 1 << 20
# committed-carry backups kept at the parent for dead-worker re-homing
_SESSION_BACKUP_CAP = 4096
# shared-memory segment names: /dev/shm/<prefix>-<parent pid>-w<i>-<n>-*
SHM_PREFIX = "ptt"

# -- frame codec -------------------------------------------------------------
#
# One wire format for both transports (ring slots and the control pipe) and
# the remote session store: [u32 header_len][header JSON][raw array bytes].
# The header's ``arrays`` lists {dtype, shape} in write order; the reader
# rebuilds each array over the received buffer. The JAX package's codec
# writes the same bytes, so either side decodes the other's frames.

_U32 = struct.Struct("<I")
_BF16 = "bfloat16"


def _raw(arr):
    """(spec, bytes view) of one array: a numpy array or a CPU tensor
    (bfloat16 tensors travel as their raw 2-byte words)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().reshape(t.shape)
            return ({"dtype": _BF16, "shape": list(arr.shape)},
                    memoryview(arr.reshape(-1).view(np.uint8)))
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return ({"dtype": str(arr.dtype), "shape": list(arr.shape)},
            memoryview(arr.reshape(-1).view(np.uint8)))


def encode_frames(header, arrays=()):
    """``(frames, total_bytes)`` of one message: the chunks (length prefix,
    header blob, one raw view per array) a transport writes back to
    back."""
    specs = []
    frames = [None, None]  # length prefix + header, filled below
    total = 0
    for arr in arrays:
        spec, view = _raw(arr)
        specs.append(spec)
        frames.append(view)
        total += view.nbytes
    blob = json.dumps(dict(header, arrays=specs),
                      separators=(",", ":")).encode("utf-8")
    frames[0] = _U32.pack(len(blob))
    frames[1] = blob
    return frames, total + len(blob) + _U32.size


def decode_buffer(buf):
    """``(header, [array])`` of one received message. Arrays are read-only
    numpy views over ``buf``; a bfloat16 array, which numpy has no dtype
    for, comes back as a CPU tensor (a copy)."""
    hlen = _U32.unpack_from(buf, 0)[0]
    header = json.loads(bytes(buf[_U32.size:_U32.size + hlen])
                        .decode("utf-8"))
    off = _U32.size + hlen
    arrays = []
    for spec in header.pop("arrays", []):
        shape = tuple(int(d) for d in spec["shape"])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if spec["dtype"] == _BF16:
            words = np.frombuffer(buf, dtype=np.int16, count=count,
                                  offset=off).copy()
            arrays.append(torch.from_numpy(words).view(torch.bfloat16)
                          .reshape(shape))
            off += count * 2
            continue
        dtype = np.dtype(spec["dtype"])
        arrays.append(np.frombuffer(buf, dtype=dtype, count=count,
                                    offset=off).reshape(shape))
        off += count * dtype.itemsize
    return header, arrays


def encode_state(state):
    """A session carry as (header, arrays) for migration: the leaves as raw
    bytes (the restore is bitwise), the layer layout, position and
    priority in the header."""
    layout, arrays = [], []
    for layer in sorted(state.carry):
        leaves = state.carry[layer]
        layout.append([layer, len(leaves)])
        arrays.extend(leaves)
    header = {"pos": int(state.pos), "priority": state.priority,
              "layout": layout}
    return header, arrays


def decode_state(sid, header, arrays):
    carry, i = {}, 0
    for layer, n in header["layout"]:
        carry[layer] = [a if torch.is_tensor(a) else np.asarray(a)
                        for a in arrays[i:i + n]]
        i += n
    return SessionState(sid, carry, header["pos"],
                        header.get("priority") or "normal")


def ring_slot_bytes(bundle, margin=1 << 16):
    """The ring slot size from the manifest's buckets: the largest request
    (the largest bucket's feeds) or answer (that bucket times ``seq_len``
    output rows) plus header margin, page-rounded."""
    rows = int(bundle.max_batch())
    steps = int(bundle.seq_len or 1)
    req = 0
    for spec in bundle.inputs:
        shape = bundle.feed_shape(spec, rows)
        req += (int(np.prod(shape, dtype=np.int64))
                * np.dtype(spec["dtype"]).itemsize)
        if spec["kind"] in ("seq_index", "seq_dense"):
            req += rows * 4  # the :lens side array
    resp = 0
    for out in bundle.outputs:
        suffix = int(np.prod(out.get("shape_suffix") or [1],
                             dtype=np.int64))
        # bfloat16 outputs are widened to float32 on the way out
        itemsize = (4 if out["dtype"] == _BF16
                    else np.dtype(out["dtype"]).itemsize)
        resp += max(rows, 1) * max(steps, 1) * suffix * itemsize
    nbytes = max(req, resp, 1 << 12) + margin
    return (nbytes + 4095) & ~4095


# -- the shared-memory ring --------------------------------------------------

_FREE, _WRITING, _READY, _READING = 0, 1, 2, 3
_SLOT_HDR = struct.Struct("<II")  # state, payload length
_SPIN = 200  # busy-poll iterations before the doorbell wait


def _wait_bell(bell, ready, timeout):
    """Wait on a doorbell semaphore until ``ready()`` or ``timeout``:
    stale rings are drained first, then the state is read again, so a
    ring that came before the wait is never missed."""
    while bell.acquire(False):
        pass
    if ready():
        return True
    bell.acquire(timeout=timeout)
    return ready()


class ShmRing:
    """A single-producer single-consumer message ring over one
    ``SharedMemory`` segment: ``slots`` slots of ``slot_bytes``, a state
    word per slot (FREE -> WRITING -> READY -> READING -> FREE) written
    last on publish, so a reader never sees a half-written slot, and one
    doorbell per direction (a counting semaphore: data for the consumer,
    space for the producer) for the busy-poll-then-wait handoff. A
    semaphore's ring never blocks and no lock is shared with the peer, so
    a peer that is stopped or killed at any instruction cannot wedge this
    side."""

    def __init__(self, name, slots, slot_bytes, data_bell, space_bell,
                 create=False):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._stride = _SLOT_HDR.size + self.slot_bytes
        self._data_bell = data_bell
        self._space_bell = space_bell
        size = self._stride * self.slots
        # a spawned worker attaching registers the segment with the
        # parent's resource tracker again (a set: no-op); the parent's
        # unlink balances it
        self.shm = shared_memory.SharedMemory(
            name=name, create=create, size=size if create else 0)
        self.name = self.shm.name
        self._buf = self.shm.buf
        if create:
            for i in range(self.slots):
                _SLOT_HDR.pack_into(self._buf, i * self._stride, _FREE, 0)
        self._w = 0
        self._r = 0

    def _state(self, off):
        return _SLOT_HDR.unpack_from(self._buf, off)[0]

    def put_frames(self, frames, nbytes, timeout=30.0):
        """Publish one message into the next slot; blocks while the ring is
        full and raises ``TimeoutError`` when the consumer never frees a
        slot (a dead peer)."""
        if nbytes > self.slot_bytes:
            raise ValueError(
                "message of %d bytes exceeds the ring slot size %d "
                "(sized from the bundle manifest's bucket specs)"
                % (nbytes, self.slot_bytes))
        off = (self._w % self.slots) * self._stride
        deadline = time.monotonic() + timeout
        spins = 0

        def free():
            return self._state(off) == _FREE

        while not free():
            spins += 1
            if spins < _SPIN:
                continue
            if not _wait_bell(self._space_bell, free, 0.05) \
                    and time.monotonic() > deadline:
                raise TimeoutError(
                    "ring full for %.0fs: consumer not draining"
                    % timeout)
        _SLOT_HDR.pack_into(self._buf, off, _WRITING, 0)
        pos = off + _SLOT_HDR.size
        for frame in frames:
            view = memoryview(frame).cast("B")
            self._buf[pos:pos + view.nbytes] = view
            pos += view.nbytes
        # publish: READY only after the payload landed
        _SLOT_HDR.pack_into(self._buf, off, _READY, nbytes)
        self._w += 1
        self._data_bell.release()

    def get(self, timeout=0.05):
        """One message (bytes), or ``None`` on timeout."""
        off = (self._r % self.slots) * self._stride
        spins = 0

        def ready():
            return self._state(off) == _READY

        while not ready():
            spins += 1
            if spins < _SPIN:
                continue
            if not _wait_bell(self._data_bell, ready, timeout):
                return None
        length = _SLOT_HDR.unpack_from(self._buf, off)[1]
        _SLOT_HDR.pack_into(self._buf, off, _READING, length)
        pos = off + _SLOT_HDR.size
        out = bytes(self._buf[pos:pos + length])  # the one copy out
        _SLOT_HDR.pack_into(self._buf, off, _FREE, 0)
        self._r += 1
        self._space_bell.release()
        return out

    def close(self):
        self._buf = None
        try:
            self.shm.close()
        except Exception:  # noqa: BLE001 — idempotent teardown
            pass

    def unlink(self):
        try:
            self.shm.unlink()
        except Exception:  # noqa: BLE001 — already gone is fine
            pass


# -- pipe RPC ----------------------------------------------------------------

class _Rpc:
    """Request/response RPC over a duplex ``Pipe`` with the frame codec
    (``send_bytes`` / ``recv_bytes``, no pickle). One outstanding call per
    side; callers serialize on their own lock. ``call`` stamps a sequence
    number and drops replies of earlier calls that timed out."""

    def __init__(self, conn):
        self.conn = conn
        self._seq = 0

    def send(self, header, arrays=()):
        frames, _total = encode_frames(header, arrays)
        self.conn.send_bytes(b"".join(bytes(f) for f in frames))

    def recv(self, timeout=None):
        if timeout is not None and not self.conn.poll(timeout):
            raise TimeoutError("rpc peer silent for %.1fs" % timeout)
        return decode_buffer(self.conn.recv_bytes())

    def call(self, header, arrays=(), timeout=10.0):
        self._seq += 1
        seq = self._seq
        self.send(dict(header, seq=seq), arrays)
        deadline = time.monotonic() + timeout
        while True:
            reply, out = self.recv(timeout=max(deadline - time.monotonic(),
                                               0.0))
            if reply.get("seq") == seq:
                reply.pop("seq", None)
                return reply, out
            # a late reply of a call that already timed out: drop it

    def close(self):
        try:
            self.conn.close()
        except Exception:  # noqa: BLE001 — idempotent teardown
            pass


def _error_header(exc):
    """A serving exception by value, for the response ring and the RPC;
    the parent raises the matching type again."""
    if isinstance(exc, Overloaded):
        return {"error": "Overloaded", "message": str(exc),
                "model": exc.model, "priority": exc.priority,
                "reason": exc.reason, "queued": exc.queued}
    if isinstance(exc, SessionGone):
        return {"error": "SessionGone", "message": str(exc),
                "session_id": exc.session_id, "reason": exc.reason}
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return {"error": type(exc).__name__, "message": str(exc)}
    return {"error": "RuntimeError",
            "message": "%s: %s" % (type(exc).__name__, exc)}


def _raise_error(header):
    kind, msg = header.get("error"), header.get("message", "")
    if kind == "Overloaded":
        raise Overloaded(msg, model=header.get("model"),
                         priority=header.get("priority"),
                         reason=header.get("reason"),
                         queued=header.get("queued"))
    if kind == "SessionGone":
        raise SessionGone(msg, session_id=header.get("session_id"),
                          reason=header.get("reason"))
    if kind == "KeyError":
        raise KeyError(msg)
    if kind == "ValueError":
        raise ValueError(msg)
    if kind == "TypeError":
        raise TypeError(msg)
    raise RuntimeError(msg)


# -- the worker process ------------------------------------------------------

def kernel_launches():
    """This process's kernel launch counters, by kernel."""
    from paddle_tpu_torch.ops import (conv_kernels, gru_kernels,
                                      int8_kernels, lstm_kernels)

    return {"lstm_seq_fwd": lstm_kernels.launches,
            "gru_seq_fwd": gru_kernels.launches,
            "int8_matmul": int8_kernels.launches,
            "conv2d_same_fwd": conv_kernels.launches}


def _op_traces():
    """``traces`` control verb: this worker's exemplar reservoir and trace
    counters, slowest first (the router merges the dumps fleet-wide with
    ``worker=`` provenance). Host dict copies only: nothing on this path
    may touch a device value (it is lint-hot by contract)."""
    from paddle_tpu_torch.observe import tracing

    return {"ok": True, "traces": tracing.debug_traces()}


def _op_history():
    """``history`` control verb: this worker's windowed health-history
    snapshot (torn-read free by HealthHistory's lock), merged at the
    router by epoch."""
    return {"ok": True, "history": observe_health.get_history().snapshot()}


def _worker_main(index, bundle_dir, device, continuous, engine_kwargs,
                 model, run_name, conn, ring_spec, warmup):
    """Entry point of one worker process (spawned): load the bundle on
    ``device``, build the engine, then serve the request ring and the
    control pipe until told to stop."""
    import contextlib
    import signal

    # Ctrl-C reaches the whole process group: the parent owns the graceful
    # path (stop RPC -> drain -> join)
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    from paddle_tpu_torch.observe import steplog as slog_mod
    from paddle_tpu_torch.observe import tracing as tracing_mod
    from paddle_tpu_torch.serve.bundle import load_bundle
    from paddle_tpu_torch.serve.engine import InferenceEngine
    from paddle_tpu_torch.serve.scheduler import ContinuousScheduler

    rpc = _Rpc(conn)
    with contextlib.ExitStack() as stack:
        req_ring = ShmRing(ring_spec["req"], ring_spec["slots"],
                           ring_spec["slot_bytes"],
                           ring_spec["req_data"], ring_spec["req_space"])
        resp_ring = ShmRing(ring_spec["resp"], ring_spec["slots"],
                            ring_spec["slot_bytes"],
                            ring_spec["resp_data"],
                            ring_spec["resp_space"])
        stack.callback(req_ring.close)
        stack.callback(resp_ring.close)

        bundle = load_bundle(bundle_dir, device=device)
        slog = slog_mod.from_env(run_name="%s-w%d" % (run_name, index),
                                 meta={"phase": "serve",
                                       "worker": index},
                                 flush_every=32)
        engine_cls = ContinuousScheduler if continuous else InferenceEngine
        engine = engine_cls(bundle, warmup="async" if warmup else False,
                            metrics_registry=observe_metrics.get_registry(),
                            model=model, replica=index, steplog=slog,
                            **dict(engine_kwargs or {}))
        # the worker's own knobs: the parent discovers them over "knobs"
        # and moves them over "set_knob"; the hooks run here, beside the
        # engine's locks
        from paddle_tpu_torch.control.knobs import KnobRegistry

        knob_reg = KnobRegistry()
        engine.register_knobs(knob_reg)

        stop_evt = threading.Event()
        out_q = collections.deque()
        out_cv = threading.Condition()
        # session submits serialize against the backup/export path, so a
        # backup's export -> import window never meets a fresh chunk
        session_mu = threading.Lock()

        def _complete(req_id, fut):
            try:
                result = fut.result()
                header = {"id": req_id, "outputs": list(result.keys())}
                arrays = list(result.values())
            except Exception as exc:  # noqa: BLE001 — shipped by value
                header = dict(_error_header(exc), id=req_id)
                arrays = []
            with out_cv:
                out_q.append((header, arrays))
                out_cv.notify()

        def _rx_loop():
            while not stop_evt.is_set():
                buf = req_ring.get(timeout=0.05)
                if buf is None:
                    continue
                header, arrays = decode_buffer(buf)
                req_id = header["id"]
                inputs = dict(zip(header["inputs"], arrays))
                trace = None
                parent = header.get("traceparent")
                if parent:
                    trace = tracing_mod.TraceContext.from_traceparent(
                        parent)
                try:
                    sid = header.get("session")
                    if sid is not None:
                        with session_mu:
                            fut = engine.submit(
                                inputs, session_id=sid,
                                priority=header.get("priority"),
                                end_session=bool(
                                    header.get("end_session")),
                                trace=trace)
                    else:
                        fut = engine.submit(inputs, trace=trace)
                except Exception as exc:  # noqa: BLE001 — by value
                    with out_cv:
                        out_q.append((dict(_error_header(exc),
                                           id=req_id), []))
                        out_cv.notify()
                    continue
                fut.add_done_callback(
                    lambda f, rid=req_id: _complete(rid, f))

        def _tx_loop():
            while True:
                with out_cv:
                    while not out_q:
                        if stop_evt.is_set():
                            return
                        out_cv.wait(0.05)
                    header, arrays = out_q.popleft()
                frames, nbytes = encode_frames(header, arrays)
                try:
                    resp_ring.put_frames(frames, nbytes)
                except Exception:  # noqa: BLE001 — parent gone: drop
                    return

        rx = threading.Thread(target=_rx_loop,
                              name="serve-worker-rx-%d" % index,
                              daemon=True)
        tx = threading.Thread(target=_tx_loop,
                              name="serve-worker-tx-%d" % index,
                              daemon=True)
        rx.start()
        tx.start()

        def _session_op(op, header, arrays):
            sid = str(header["session"])
            if op == "has_session":
                return {"ok": True, "has": bool(engine.has_session(sid))}, ()
            if op == "close_session":
                engine.close_session(sid)
                return {"ok": True}, ()
            if op == "export_session":
                h, arrs = encode_state(engine.export_session(sid))
                return dict(h, ok=True), arrs
            if op == "import_session":
                engine.import_session(sid, decode_state(sid, header, arrays))
                return {"ok": True}, ()
            if op == "backup_session":
                # the committed carry: export then re-import, atomically
                # against data-plane submits of the id
                with session_mu:
                    state = engine.export_session(sid)
                    engine.import_session(sid, state)
                h, arrs = encode_state(state)
                return dict(h, ok=True), arrs
            raise ValueError("unknown session op %r" % op)

        # the control loop (the worker's main thread): one message at a
        # time, each reply stamped with its call's sequence number
        stop_seq = None
        while True:
            try:
                header, arrays = rpc.recv(timeout=1.0)
            except TimeoutError:
                continue
            except (EOFError, OSError):
                break  # the parent is gone: drain below
            op = header.get("op")
            seq = {"seq": header.get("seq")}
            try:
                if op == "ping":
                    rpc.send(dict(seq, ok=True, ready=engine.ready(),
                                  live=engine.live(),
                                  queue_depth=engine.queue_depth(),
                                  compiles=len(bundle.load_seconds),
                                  pid=os.getpid()))
                elif op == "stats":
                    rpc.send(dict(seq, ok=True, stats=dict(
                        engine.stats(), pid=os.getpid(),
                        kernel_launches=kernel_launches())))
                elif op == "metrics":
                    rpc.send(dict(seq, ok=True,
                                  families=engine.metrics.dump_series()))
                elif op == "traces":
                    rpc.send(dict(seq, **_op_traces()))
                elif op == "history":
                    rpc.send(dict(seq, **_op_history()))
                elif op == "compiles":
                    rpc.send(dict(seq, ok=True,
                                  compiles=len(bundle.load_seconds)))
                elif op == "knobs":
                    rpc.send(dict(seq, ok=True, knobs=knob_reg.snapshot()))
                elif op == "set_knob":
                    old, new = knob_reg.set(str(header["knob"]),
                                            header["value"])
                    rpc.send(dict(seq, ok=True, old=old, new=new))
                elif op == "stop":
                    stop_seq = header.get("seq")
                    break
                elif op in ("has_session", "close_session",
                            "export_session", "import_session",
                            "backup_session"):
                    h, arrs = _session_op(op, header, arrays)
                    rpc.send(dict(h, **seq), arrs)
                else:
                    rpc.send(dict(seq, error="ValueError",
                                  message="unknown rpc op %r" % op))
            except Exception as exc:  # noqa: BLE001 — shipped by value
                rpc.send(dict(_error_header(exc), **seq))

        # drain: stop the engine (its queue and step log), push the last
        # answers out, then ack the stop
        stop_evt.set()
        try:
            engine.stop(timeout=30.0)
        except Exception:  # noqa: BLE001 — still ack the stop
            pass
        rx.join(timeout=5.0)
        with out_cv:
            pending = list(out_q)
            out_q.clear()
        for header, arrays in pending:
            frames, nbytes = encode_frames(header, arrays)
            try:
                resp_ring.put_frames(frames, nbytes, timeout=1.0)
            except Exception:  # noqa: BLE001 — the parent stopped reading
                break
        tx.join(timeout=5.0)
        if slog is not None:
            slog.close()
        try:
            rpc.send({"ok": True, "stopped": True, "seq": stop_seq})
        except Exception:  # noqa: BLE001 — the pipe may be gone
            pass
        rpc.close()


# -- parent-side worker handle -----------------------------------------------

class _WorkerHandle:
    """One worker process as the parent sees it: the process, its two
    rings, the control RPC and the pending-request table, whose size is the
    worker's queue depth (no RPC on the dispatch path)."""

    def __init__(self, owner, index):
        self._owner = owner
        self.index = index
        self.device = owner.devices[index % len(owner.devices)]
        self._tx_lock = threading.Lock()       # request-ring writers
        self._rpc_lock = threading.Lock()      # control-pipe callers
        self._pending_lock = threading.Lock()  # pending futures
        self._state_lock = threading.Lock()    # liveness and readiness
        self._pending = {}
        self._dead = False
        self._ready = False
        self._booted = False
        self._ping_failures = 0
        self.process = None
        self._rpc = None
        self._req_ring = None
        self._resp_ring_ref = None
        self._rx_thread = None
        self._spawn()

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self):
        owner = self._owner
        ctx = owner._ctx
        tag = "%s-%d-w%d-%d" % (SHM_PREFIX, os.getpid(), self.index,
                                next(_spawn_seq))
        ring_spec = {
            "slots": owner.ring_slots,
            "slot_bytes": owner.slot_bytes,
            "req": "%s-req" % tag, "resp": "%s-resp" % tag,
            "req_data": ctx.Semaphore(0), "req_space": ctx.Semaphore(0),
            "resp_data": ctx.Semaphore(0), "resp_space": ctx.Semaphore(0),
        }
        req_ring = ShmRing(ring_spec["req"], owner.ring_slots,
                           owner.slot_bytes, ring_spec["req_data"],
                           ring_spec["req_space"], create=True)
        resp_ring = ShmRing(ring_spec["resp"], owner.ring_slots,
                            owner.slot_bytes, ring_spec["resp_data"],
                            ring_spec["resp_space"], create=True)
        parent_conn, child_conn = ctx.Pipe()
        process = ctx.Process(
            target=_worker_main,
            args=(self.index, owner.bundle.directory, str(self.device),
                  owner.continuous, owner._engine_kwargs, owner.model,
                  owner._run_name, child_conn, ring_spec, True),
            name="paddle-tpu-torch-serve-worker-%d" % self.index,
            daemon=True)
        process.start()
        child_conn.close()
        rx = threading.Thread(
            target=self._rx_loop, args=(resp_ring,),
            name="serve-worker-rx-%d" % self.index, daemon=True)
        with self._state_lock:
            self.process = process
            self._dead = False
            self._ready = False
            self._booted = False
            self._ping_failures = 0
        with self._rpc_lock:
            self._rpc = _Rpc(parent_conn)
        with self._tx_lock:
            self._req_ring = req_ring
        self._resp_ring_ref = resp_ring
        self._rx_thread = rx
        rx.start()

    def respawn(self):
        """Start a replacement process in this slot, on fresh rings."""
        self._teardown_transport()
        self._spawn()

    def dead(self):
        with self._state_lock:
            return self._dead

    def mark_dead(self):
        """Take this worker out of dispatch; reap what the OS left."""
        with self._state_lock:
            if self._dead:
                return False
            self._dead = True
            self._ready = False
            process = self.process
        if process is not None:
            process.join(timeout=0.5)
        return True

    def is_alive(self):
        with self._state_lock:
            if self._dead:
                return False
            process = self.process
        return process is not None and process.is_alive()

    def pid(self):
        with self._state_lock:
            return None if self.process is None else self.process.pid

    def ready(self):
        """Warm and alive, as the last heartbeat found it: no RPC here,
        since dispatch asks every worker on every request, and a worker
        still loading its bundle would hold each request for a
        heartbeat's timeout."""
        with self._state_lock:
            if self._dead or not self._ready:
                return False
            process = self.process
        # a killed worker leaves /readyz at once, not a heartbeat later
        return process is not None and process.is_alive()

    # -- data plane ----------------------------------------------------------
    def queue_depth(self):
        with self._pending_lock:
            return len(self._pending)

    def submit_encoded(self, req_id, header, arrays, future, entry):
        """Register the pending future, then publish the request (the
        answer can race back before the writer returns)."""
        frames, nbytes = encode_frames(header, arrays)
        with self._pending_lock:
            self._pending[req_id] = entry
        try:
            with self._tx_lock:
                self._req_ring.put_frames(frames, nbytes)
        except Exception:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise
        return future

    def _rx_loop(self, ring):
        """The answer pump: decode, find the pending future, resolve. The
        ring is an argument, so a respawned worker's pump never reads an
        earlier incarnation's segment."""
        while True:
            with self._state_lock:
                if self._dead:
                    break
            buf = ring.get(timeout=0.05)
            if buf is None:
                continue
            self._dispatch_response(buf)

    def join_rx(self, timeout=2.0):
        rx = self._rx_thread
        if rx is not None and rx is not threading.current_thread():
            rx.join(timeout=timeout)

    def drain_responses(self):
        """Read every answer already published: the last read before a
        dead worker's pending table fails over, so an answered request is
        never replayed. Callers stop the pump first (mark dead, then
        ``join_rx``): the ring has one consumer."""
        ring = self._resp_ring_ref
        if ring is None:
            return
        while True:
            buf = ring.get(timeout=0.0)
            if buf is None:
                return
            self._dispatch_response(buf)

    def _dispatch_response(self, buf):
        header, arrays = decode_buffer(buf)
        req_id = header.get("id")
        with self._pending_lock:
            entry = self._pending.pop(req_id, None)
        if entry is None:
            return  # a late answer after failover
        future = entry["future"]
        if future.done():
            return
        if "error" in header:
            try:
                _raise_error(header)
            except Exception as exc:  # noqa: BLE001 — the future carries it
                future.set_exception(exc)
            return
        result = dict(zip(header["outputs"], arrays))
        self._owner._note_completed(self, entry)
        future.set_result(result)

    def take_pending(self):
        with self._pending_lock:
            pending = dict(self._pending)
            self._pending.clear()
        return pending

    # -- control plane -------------------------------------------------------
    def rpc(self, header, arrays=(), timeout=10.0):
        with self._rpc_lock:
            reply, out = self._rpc.call(header, arrays, timeout=timeout)
        with self._state_lock:
            self._booted = True
        if "error" in reply:
            _raise_error(reply)
        return reply, out

    def try_rpc(self, header, timeout=2.0):
        """A best-effort control call (heartbeat, stats, metrics): None
        when the worker is busy stopping, dead or silent."""
        # timed acquire instead of `with`: the heartbeat must not wedge
        # behind a slow call — _rpc_lock IS held for the accesses below
        # (released in the finally), the AST checker just cannot see a
        # timed acquire
        if not self._rpc_lock.acquire(timeout=timeout):
            return None
        try:
            if self._rpc is None:  # paddle-lint: disable=PTA005
                return None
            reply, _ = self._rpc.call(header, timeout=timeout)  # paddle-lint: disable=PTA005
        except Exception:  # noqa: BLE001 — the heartbeat decides liveness
            return None
        finally:
            self._rpc_lock.release()
        with self._state_lock:
            self._booted = True
        return reply

    def ping(self):
        """One heartbeat; returns the consecutive missed heartbeats, which
        count only once the worker answered at all (loading a bundle can
        take many seconds)."""
        reply = self.try_rpc({"op": "ping"})
        with self._state_lock:
            if reply is None:
                if self._booted:
                    self._ping_failures += 1
                failures = self._ping_failures
            else:
                self._ping_failures = 0
                self._ready = bool(reply.get("ready"))
                failures = 0
        return failures

    # -- teardown ------------------------------------------------------------
    def _teardown_transport(self):
        with self._rpc_lock:
            if self._rpc is not None:
                self._rpc.close()
                self._rpc = None
        rx = self._rx_thread
        if rx is not None and rx is not threading.current_thread():
            rx.join(timeout=2.0)
        with self._tx_lock:
            if self._req_ring is not None:
                self._req_ring.close()
                self._req_ring.unlink()
                self._req_ring = None
        ring = self._resp_ring_ref
        if ring is not None:
            ring.close()
            ring.unlink()
            self._resp_ring_ref = None

    def shutdown(self, timeout=30.0):
        """Graceful stop: the stop RPC (the worker drains and flushes),
        join against the deadline, then terminate, then kill; then the
        rings and the pipe. Leaks no child and no segment."""
        deadline = time.monotonic() + timeout
        with self._state_lock:
            process = self.process
            was_dead = self._dead
        if process is not None and process.is_alive() and not was_dead:
            reply = self.try_rpc({"op": "stop"},
                                 timeout=max(timeout - 1.0, 1.0))
            if reply is not None:
                # the worker acked: its last answers are in the ring; let
                # the pump resolve them before it stops
                drain_deadline = time.monotonic() + min(
                    2.0, max(deadline - time.monotonic(), 0.1))
                while time.monotonic() < drain_deadline:
                    with self._pending_lock:
                        if not self._pending:
                            break
                    time.sleep(0.01)
        with self._state_lock:
            self._dead = True
            self._ready = False
        self.join_rx()
        self.drain_responses()
        if process is not None:
            process.join(timeout=max(deadline - time.monotonic(), 0.1))
            if process.is_alive():
                process.terminate()
                process.join(timeout=2.0)
            if process.is_alive():
                process.kill()
                process.join(timeout=2.0)
        self._teardown_transport()
        for entry in self.take_pending().values():
            future = entry["future"]
            if not future.done():
                future.set_exception(Overloaded(
                    "worker %d stopped before the request completed"
                    % self.index, model=self._owner.model,
                    reason="no_replica"))


# -- merged metrics view -----------------------------------------------------

class _MergedMetrics:
    """The ``/metrics`` view of a WorkerSet: the parent registry's families
    merged with each live worker's snapshot under an injected
    ``{worker=}`` label."""

    def __init__(self, owner, registry):
        self._owner = owner
        self.registry = registry

    def to_prometheus(self):
        return observe_metrics.merged_exposition(self.registry,
                                                 self._owner.metric_dumps())

    def snapshot(self):
        snap = self.registry.snapshot()
        snap["workers"] = {labels["worker"]: families
                           for families, labels
                           in self._owner.metric_dumps()}
        return snap

    # router-side series (the shed counter) register on the registry
    def counter(self, *args, **kwargs):
        return self.registry.counter(*args, **kwargs)

    def gauge(self, *args, **kwargs):
        return self.registry.gauge(*args, **kwargs)

    def histogram(self, *args, **kwargs):
        return self.registry.histogram(*args, **kwargs)


# -- the worker fleet --------------------------------------------------------

_spawn_seq = itertools.count(1)
_live_sets_lock = threading.Lock()
_live_sets = weakref.WeakSet()
_sweep_registered = False


def _atexit_sweep():
    with _live_sets_lock:
        sets = list(_live_sets)
    for ws in sets:
        try:
            ws.stop(timeout=10.0)
        except Exception:  # noqa: BLE001 — best-effort crash sweep
            pass


def worker_devices(bundle):
    """The devices workers cycle over: ``cuda:{i}`` for every card when
    the parent's bundle is on a card, else ``cpu``."""
    if bundle.device.type == "cuda":
        return ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    return ["cpu"]


class WorkerSet:
    """N serving replicas as N worker processes behind the fleet front
    door, duck-typed like :class:`~paddle_tpu_torch.serve.fleet.ReplicaSet`
    (submit/infer/ready/live/stats/queue_depth/stop and session affinity).

    ``bundle`` is the parent's load (the manifest for ring sizing and
    routing, its device for placement); worker ``i`` loads its own copy
    from ``bundle.directory`` on ``worker_devices(bundle)[i % count]``
    (:func:`worker_devices`). ``engine_kwargs`` passes through
    to every worker's engine; ``respawn=True`` restarts a dead worker;
    ``session_backup`` (on by default) snapshots each session's carry at
    the parent after every completed chunk."""

    def __init__(self, bundle, workers=None, continuous=False,
                 engine_kwargs=None, metrics_registry=None, model=None,
                 run_name="serve", respawn=False, session_backup=True,
                 ring_slots=64, slot_bytes=None, heartbeat_interval=0.25):
        import multiprocessing

        n = 1 if workers is None else int(workers)
        if n < 1:
            raise ValueError("workers must be >= 1, got %r" % workers)
        self.bundle = bundle
        self.devices = worker_devices(bundle)
        if not self.devices:
            raise ValueError("no devices to place workers on")
        self.model = model
        self.continuous = bool(continuous)
        self.respawn = bool(respawn)
        self.session_backup = bool(session_backup)
        self.ring_slots = int(ring_slots)
        self.slot_bytes = int(slot_bytes or ring_slot_bytes(bundle))
        self.heartbeat_interval = float(heartbeat_interval)
        self._engine_kwargs = dict(engine_kwargs or {})
        self._run_name = run_name
        # spawn, never fork: the parent may hold a live CUDA context
        self._ctx = multiprocessing.get_context("spawn")
        registry = metrics_registry or observe_metrics.get_registry()
        self.metrics = _MergedMetrics(self, registry)
        # the static capacity gate of ReplicaSet: N processes, N copies
        from paddle_tpu_torch.serve.fleet import fleet_hbm_check

        self.hbm_estimate_bytes, self.hbm_note = fleet_hbm_check(bundle, n)
        shed_labels = {"reason": "no_replica"}
        if model:
            shed_labels["model"] = str(model)
        self._m_shed = registry.counter(
            "paddle_tpu_serve_shed_total",
            help="requests rejected by admission control",
            labels=shed_labels)
        self._lock = threading.Lock()
        self._rr = 0
        self._req_ids = itertools.count(1)
        self._stats = collections.Counter()
        self._stopped = False
        self._ring = (ConsistentHashRing(list(range(n)))
                      if continuous else None)
        self._session_home = collections.OrderedDict()
        self._session_backups = collections.OrderedDict()
        self._migrate_lock = threading.Lock()
        self._handles = tuple(_WorkerHandle(self, i) for i in range(n))
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="serve-worker-heartbeat",
            daemon=True)
        self._hb_thread.start()
        global _sweep_registered
        with _live_sets_lock:
            _live_sets.add(self)
            if not _sweep_registered:
                atexit.register(_atexit_sweep)
                _sweep_registered = True

    def workers(self):
        """The worker handles, in index order."""
        return self._handles

    def replicas(self):
        return self._handles

    @property
    def supports_sessions(self):
        return self.continuous

    # -- dispatch ------------------------------------------------------------
    def _eligible(self):
        return [h for h in self._handles
                if not h.dead() and h.is_alive() and h.ready()]

    def submit(self, inputs, session_id=None, priority=None,
               end_session=False, trace=None):
        """Dispatch one request to the least-queued eligible worker
        (round-robin among ties) through its ring; returns a Future.
        Session requests follow the ring with cross-process carry
        migration. Raises :class:`Overloaded` (reason ``no_replica``)
        when every worker is cold or dead."""
        eligible = self._eligible()
        if not eligible:
            self._m_shed.inc()
            observe_health.get_history().record_shed("no_replica")
            raise Overloaded(
                "no warm live worker (fleet of %d still warming or "
                "failed) — retry after /readyz goes green"
                % len(self._handles),
                model=self.model, reason="no_replica")
        if session_id is not None:
            if self._ring is None:
                raise ValueError(
                    "this worker fleet does not hold sessions (whole-"
                    "request engines); construct with continuous=True "
                    "over a decode-capable bundle")
            handle = self._route_session(str(session_id), eligible)
            return self._submit_to(handle, inputs,
                                   session_id=str(session_id),
                                   priority=priority,
                                   end_session=end_session, trace=trace)
        n = len(eligible)
        with self._lock:
            offset = self._rr
            self._rr = (self._rr + 1) % n
        order = [eligible[(offset + j) % n] for j in range(n)]
        depths = [h.queue_depth() for h in order]
        best = min(range(n), key=lambda j: (depths[j], j))
        return self._submit_to(order[best], inputs, trace=trace)

    def submit_to(self, index, inputs, timeout=None, trace=None):
        """Pin one request to worker ``index``; returns a Future. The JAX
        package's signature: ``timeout`` is accepted and unused (the
        caller's ``result(timeout=)`` bounds the wait)."""
        return self._submit_to(self._handles[index], inputs, trace=trace)

    def _submit_to(self, handle, inputs, session_id=None, priority=None,
                   end_session=False, trace=None):
        names, arrays = [], []
        for name, value in inputs.items():
            names.append(str(name))
            arrays.append(np.asarray(value))
        header = {"id": next(self._req_ids), "inputs": names}
        if session_id is not None:
            header["session"] = session_id
            if end_session:
                header["end_session"] = True
        if priority is not None:
            header["priority"] = str(priority)
        if trace is not None and getattr(trace, "trace_id", None):
            # the trace context crosses by value, as its traceparent
            header["traceparent"] = trace.traceparent()
        future = Future()
        entry = {"future": future, "header": header, "arrays": arrays,
                 "session": session_id, "retries": 0}
        with self._lock:
            self._stats["dispatched"] += 1
        handle.submit_encoded(header["id"], header, arrays, future, entry)
        return future

    def infer(self, inputs, timeout=60.0, session_id=None, priority=None,
              end_session=False, trace=None):
        return self.submit(inputs, session_id=session_id,
                           priority=priority, end_session=end_session,
                           trace=trace).result(timeout=timeout)

    def queue_depth(self):
        return sum(h.queue_depth() for h in self._handles)

    # -- session routing -----------------------------------------------------
    def _route_session(self, sid, eligible):
        eligible_idx = {h.index for h in eligible}
        target = next((self._handles[idx] for idx in self._ring.order(sid)
                       if idx in eligible_idx), eligible[0])
        with self._lock:
            home = self._session_home.get(sid)
        if home is None:
            # the bounded table forgot: probe the live workers before
            # taking the session for new
            for handle in eligible:
                if handle.index == target.index:
                    continue
                try:
                    reply, _ = handle.rpc({"op": "has_session",
                                           "session": sid}, timeout=5.0)
                except Exception:  # noqa: BLE001 — a probe only
                    continue
                if reply.get("has"):
                    home = handle.index
                    break
        if home is not None and home != target.index:
            with self._migrate_lock:
                with self._lock:
                    current = self._session_home.get(sid)
                if current is not None:
                    home = current
                if home != target.index:
                    self._migrate(sid, home, target)
            return target
        if home is None:
            self._restore_backup(sid, target)
        self._set_home(sid, target.index)
        return target

    def _migrate(self, sid, home, target):
        """Pull a session's carry across processes: export over the old
        home's RPC, import at the target, through the frame codec (the
        restored carry is bitwise-equal); the committed backup when the
        old home is dead."""
        old = self._handles[home]
        state = None
        if not old.dead() and old.is_alive():
            try:
                reply, arrays = old.rpc({"op": "export_session",
                                         "session": sid}, timeout=30.0)
                state = decode_state(sid, reply, arrays)
            except SessionGone:
                raise  # evicted at its home is gone fleet-wide
            except Exception:  # noqa: BLE001 — unknown there, or it died
                state = None
        if state is None:
            self._restore_backup(sid, target)
        else:
            header, arrays = encode_state(state)
            target.rpc(dict(header, op="import_session", session=sid),
                       arrays, timeout=30.0)
            with self._lock:
                self._stats["migrations"] += 1
        self._set_home(sid, target.index)

    def _restore_backup(self, sid, target):
        with self._lock:
            backup = self._session_backups.get(sid)
        if backup is None:
            return False
        header, arrays = backup
        try:
            target.rpc(dict(header, op="import_session", session=sid),
                       arrays, timeout=30.0)
        except Exception:  # noqa: BLE001 — target died; the next route retries
            return False
        with self._lock:
            self._stats["backup_restores"] += 1
        return True

    def _set_home(self, sid, index):
        with self._lock:
            self._session_home[sid] = index
            self._session_home.move_to_end(sid)
            while len(self._session_home) > _SESSION_HOME_CAP:
                self._session_home.popitem(last=False)

    def _note_completed(self, handle, entry):
        """Answer-path bookkeeping (on the handle's pump thread, before the
        future resolves): count it, and for a session chunk refresh the
        committed-carry backup, the state a dead worker's sessions re-home
        from."""
        with self._lock:
            self._stats["completed"] += 1
        sid = entry.get("session")
        if sid is None or not self.session_backup:
            return
        if entry["header"].get("end_session"):
            with self._lock:
                self._session_backups.pop(sid, None)
            return
        try:
            reply, arrays = handle.rpc(
                {"op": "backup_session", "session": sid}, timeout=10.0)
        except Exception:  # noqa: BLE001 — a missed backup replays from
            return  # the previous one
        reply.pop("ok", None)
        with self._lock:
            self._session_backups[sid] = (reply, arrays)
            self._session_backups.move_to_end(sid)
            while len(self._session_backups) > _SESSION_BACKUP_CAP:
                self._session_backups.popitem(last=False)

    def close_session(self, session_id):
        if self._ring is None:
            return
        sid = str(session_id)
        with self._lock:
            home = self._session_home.pop(sid, None)
            self._session_backups.pop(sid, None)
        handles = ([self._handles[home]] if home is not None
                   else self._handles)
        for handle in handles:
            if handle.dead() or not handle.is_alive():
                continue
            try:
                handle.rpc({"op": "close_session", "session": sid},
                           timeout=10.0)
            except Exception:  # noqa: BLE001 — close is best-effort
                pass

    # -- failure handling ----------------------------------------------------
    def _heartbeat_loop(self):
        while not self._hb_stop.is_set():
            for handle in self._handles:
                if self._hb_stop.is_set():
                    return
                if handle.dead():
                    continue
                if not handle.is_alive():
                    self._on_worker_death(handle)
                    continue
                if handle.ping() >= 3:
                    self._on_worker_death(handle)
            self._hb_stop.wait(self.heartbeat_interval)

    def _on_worker_death(self, handle):
        """A worker died: leave it out of dispatch, read out every answer
        it published, re-route its in-flight requests, drop its routing
        hints (its sessions re-home from their backups on their next
        chunk), and respawn it when asked to."""
        if not handle.mark_dead():
            return  # another path handled it
        handle.join_rx()
        handle.drain_responses()
        with self._lock:
            self._stats["worker_deaths"] += 1
            stopped = self._stopped
            for sid, home in list(self._session_home.items()):
                if home == handle.index:
                    del self._session_home[sid]
        for entry in handle.take_pending().values():
            self._reroute(entry)
        handle._teardown_transport()
        if self.respawn and not stopped:
            handle.respawn()
            with self._lock:
                self._stats["respawns"] += 1

    def _reroute(self, entry):
        """Dispatch one in-flight request of a dead worker again. A session
        chunk replays against its last committed carry, so a deterministic
        decode gives the lost chunk bitwise."""
        future = entry["future"]
        if future.done():
            return
        entry["retries"] += 1
        if entry["retries"] > 3:
            future.set_exception(Overloaded(
                "request re-routed %d times without completing"
                % (entry["retries"] - 1), model=self.model,
                reason="no_replica"))
            return
        try:
            eligible = self._eligible()
            if not eligible:
                raise Overloaded("no surviving worker",
                                 model=self.model, reason="no_replica")
            sid = entry.get("session")
            if sid is not None:
                target = self._route_session(sid, eligible)
            else:
                target = min(eligible,
                             key=lambda h: (h.queue_depth(), h.index))
            header = dict(entry["header"], id=next(self._req_ids))
            # counted before it is published: its answer can come back,
            # and its caller read the stats, before submit returns
            with self._lock:
                self._stats["reroutes"] += 1
            try:
                target.submit_encoded(header["id"], header, entry["arrays"],
                                      future, dict(entry, header=header))
            except Exception:
                with self._lock:
                    self._stats["reroutes"] -= 1
                raise
        except Exception as exc:  # noqa: BLE001 — the future carries it
            if not future.done():
                future.set_exception(exc)

    # -- health and stats ----------------------------------------------------
    def ready(self):
        """True once every worker finished its warmup (a dead worker keeps
        the fleet not-ready until respawned)."""
        return all(h.ready() for h in self._handles)

    def ready_detail(self):
        return {str(h.index): h.ready() for h in self._handles}

    def live(self):
        return any(not h.dead() and h.is_alive() for h in self._handles)

    def live_detail(self):
        return {str(h.index): (not h.dead() and h.is_alive())
                for h in self._handles}

    def wait_ready(self, timeout=300.0):
        """Block until every worker is warm; raises ``TimeoutError``
        otherwise, and ``RuntimeError`` at once when a worker died and
        will not be respawned."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready():
                return self
            if not self.respawn and any(h.dead() for h in self._handles):
                raise RuntimeError(
                    "worker fleet: a worker died before it was ready: %r"
                    % self.live_detail())
            time.sleep(0.05)
        raise TimeoutError("worker fleet not ready within %.0fs: %r"
                           % (timeout, self.ready_detail()))

    def metric_dumps(self):
        """``[(families, {"worker": i})]``: each live worker's metric
        snapshot (``metrics`` RPC), the extras of a merged exposition."""
        dumps = []
        for handle in self._handles:
            if handle.dead():
                continue
            reply = handle.try_rpc({"op": "metrics"}, timeout=2.0)
            if reply and reply.get("families") is not None:
                dumps.append((reply["families"],
                              {"worker": str(handle.index)}))
        return dumps

    def stats(self):
        """Parent counters plus each live worker's engine stats (over the
        RPC, with its pid and kernel launches), aggregated under
        ``ReplicaSet``'s keys."""
        per = {}
        for handle in self._handles:
            if handle.dead() or not handle.is_alive():
                per[str(handle.index)] = {"dead": True}
                continue
            reply = handle.try_rpc({"op": "stats"}, timeout=5.0)
            per[str(handle.index)] = (reply or {}).get("stats", {})
        with self._lock:
            router = dict(self._stats)
            session_routes = len(self._session_home)
            backups = len(self._session_backups)
        out = {
            "workers": len(self._handles),
            "dispatch": "least_queued_rr",
            "transport": "shm_ring",
            "devices": [str(h.device) for h in self._handles],
            "per_worker": per,
            "router": router,
        }
        for key in ("requests", "rows", "batches", "shed",
                    "queue_depth", "in_flight", "spills", "restores",
                    "evictions", "resident_sessions",
                    "suspended_sessions"):
            out[key] = sum(s.get(key, 0) for s in per.values())
        out["queue_depth"] += self.queue_depth()
        if self._ring is not None:
            out["session_routes"] = session_routes
            out["session_backups"] = backups
        if self.model:
            out["model"] = self.model
        if self.hbm_estimate_bytes is not None:
            out["hbm_estimate_bytes"] = self.hbm_estimate_bytes
        out["ready"] = self.ready()
        return out

    def register_knobs(self, registry):
        """Adopt the workers' knobs as fleet-wide proxies: the table from
        the first worker that answers ``knobs``, one proxy per name whose
        apply sends ``set_knob`` to every live worker (best effort: a
        worker mid-restart keeps its old value until the next move)."""
        from paddle_tpu_torch.control.knobs import Knob

        table = {}
        for handle in self._handles:
            if handle.dead() or not handle.is_alive():
                continue
            reply = handle.try_rpc({"op": "knobs"}, timeout=5.0)
            if reply is not None and reply.get("knobs"):
                table = reply["knobs"]
                break
        for name in sorted(table):
            desc = table[name]

            def _broadcast(v, name=name):
                for handle in self._handles:
                    if handle.dead() or not handle.is_alive():
                        continue
                    handle.try_rpc({"op": "set_knob", "knob": name,
                                    "value": v}, timeout=5.0)

            registry.register(Knob(
                name, value=desc["value"], min=desc["min"],
                max=desc["max"], step=desc["step"],
                cost_hint=desc.get("cost_hint", "cheap"),
                integer=bool(desc.get("integer")), apply=_broadcast))

    def compile_counts(self):
        """Per-worker program loads (the port's counterpart of the JAX
        workers' compile counters)."""
        out = {}
        for handle in self._handles:
            if handle.dead() or not handle.is_alive():
                continue
            reply = handle.try_rpc({"op": "compiles"}, timeout=5.0)
            if reply is not None:
                out[handle.index] = int(reply.get("compiles", 0))
        return out

    # -- teardown ------------------------------------------------------------
    def stop(self, timeout=30.0):
        """Stop every worker (drain, flush, join; terminate or kill at the
        deadline), then unlink every segment. Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._hb_stop.set()
        if self._hb_thread is not threading.current_thread():
            self._hb_thread.join(timeout=5.0)
        # the workers drain and exit at once, not one after another
        stoppers = [threading.Thread(target=h.shutdown, args=(timeout,),
                                     name="serve-worker-stop-%d" % h.index)
                    for h in self._handles]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join()
        with _live_sets_lock:
            _live_sets.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __repr__(self):
        return "WorkerSet(%r, workers=%d, continuous=%s)" % (
            self.bundle.name, len(self._handles), self.continuous)
