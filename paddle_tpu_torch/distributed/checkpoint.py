"""Durable checkpoint/restore with integrity hashing
(paddle_tpu/distributed/checkpoint.py), in the JAX package's on-disk
format: a ``pass-XXXXX-step-XXXXXXXX`` directory holding
``parameters.tar`` (``Parameters.to_tar``), ``optimizer.npz`` (a zip of
one ``.npy`` per flattened optimizer-state key: ``step``,
``slots/<name>/<i>``, ``row_step/<name>``, ``average/<name>``) and a
``meta.json`` with the sha256 manifest; every payload is fsync'd before
the atomic rename. A checkpoint written by either package loads in the
other.

Overlapped saves: the :class:`AsyncCheckpointer` moves serialization,
fsync and the atomic rename onto ONE named background thread
("ckpt-writer"). The step thread's share of a checkpoint is a device-side
clone of the training state on the compute stream and the start of its
copy into pinned host memory on a side stream (the trainer's
``_checkpoint_overlapped``), handed over as a :class:`CheckpointSnapshot`
with the copy's event; the writer waits on the event, builds the
directory and commits it. A snapshot submitted while the writer is still
busy REPLACES the pending one (newest wins), so checkpointing never
stalls the step thread.

Every commit of the writer updates the JAX package's
``paddle_tpu_checkpoint_*`` metrics families and, given a ``steplog``,
writes a ``checkpoint`` record (``duration_ms``, ``bytes``,
``overlapped``, ``step_thread_ms``, ``pass``, ``path``) and the
``checkpoint_commit`` elastic event, as the JAX writer does; its
serialization is the ``checkpoint_write`` span.
"""

import hashlib
import io
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.observe import trainview
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger

# a crashed writer (or kill -9 mid-save) leaves a .ckpt-tmp-* dir behind;
# anything older than this is garbage no in-flight save can still own
_STALE_TMP_SECS = 3600.0


def to_numpy(value):
    """A tensor (any device; bfloat16 as float32) or array as numpy."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten_state(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_state(v, prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_state(v, prefix + (str(i),), out)
    elif tree is not None and hasattr(tree, "shape"):
        out["/".join(prefix)] = to_numpy(tree)


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without directory fds: rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_payload(tmp_dir, fname, data):
    """One payload file: a single write() of the in-memory bytes, then
    fsync. Serializing into memory first keeps the writer thread's
    syscall count at one write per file (tar/zip straight to a disk
    file costs hundreds of buffered seek/tell round trips on shared
    storage) and lets the manifest hash the SAME bytes without a
    re-read. Memory cost is one checkpoint payload — the double-buffered
    design already holds a host copy of that size."""
    path = os.path.join(tmp_dir, fname)
    with open(path, "wb") as f:
        f.write(data)
    _fsync_file(path)
    return hashlib.sha256(data).hexdigest()


def save_checkpoint(directory, parameters, opt_state=None, step=0, pass_id=0,
                    keep=3, extra_meta=None):
    """Write save_dir/pass-XXXXX-step-XXXXXXXX/ atomically with a sha256
    manifest; prunes old checkpoints beyond ``keep``. Every payload file
    is fsync'd before the atomic rename (and the parent directory after),
    so a kill -9 at ANY point leaves either the previous good checkpoint
    or this one — never a torn directory that verifies. Returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    name = "pass-%05d-step-%08d" % (pass_id, step)
    final_dir = os.path.join(directory, name)
    tmp_dir = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=directory)
    try:
        # getbuffer(), not getvalue(): the zero-copy view feeds both the
        # file write and the manifest hash, so peak RSS per save stays
        # one serialized payload instead of two
        buf = io.BytesIO()
        parameters.to_tar(buf)
        files = {"parameters.tar": _write_payload(
            tmp_dir, "parameters.tar", buf.getbuffer())}
        if opt_state is not None:
            flat = {}
            _flatten_state(opt_state, (), flat)
            # np.savez via keyword args mangles odd names; write arrays with
            # explicit zip entries instead ("/" is legal in zip member names)
            import zipfile

            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as zf:
                for k, v in flat.items():
                    entry = io.BytesIO()
                    np.save(entry, v, allow_pickle=False)
                    zf.writestr(k + ".npy", entry.getvalue())
            files["optimizer.npz"] = _write_payload(
                tmp_dir, "optimizer.npz", buf.getbuffer())
        meta = {
            "format": "paddle_tpu-checkpoint-v1",
            "step": int(step),
            "pass": int(pass_id),
            "time": time.time(),
            "files": files,
        }
        if extra_meta:
            meta["extra"] = extra_meta
        _write_payload(tmp_dir, "meta.json",
                       json.dumps(meta, indent=2).encode())
        import shutil

        old_dir = None
        for attempt in range(3):
            stale_meta_sha = None
            if os.path.exists(final_dir):
                # replacing a stale same-name commit (a reform rewound
                # and re-trained to this step) must NOT open a destroy
                # window: rmtree-then-rename would leave NO checkpoint
                # under this name if the process is killed in between.
                # Move the old one aside atomically instead — a kill
                # between the two renames hides it from
                # latest_checkpoint but never tears it, and the earlier
                # kept checkpoints remain the fallback. A failure HERE
                # propagates: the stale dir is still in place, and
                # blessing it as "committed" would hand a later resume
                # pre-reform state. Its meta hash is remembered so a
                # commit-race winner can be told apart from this very
                # dir resurrected by a concurrent adoption scan.
                try:
                    stale_meta_sha = _sha256(
                        os.path.join(final_dir, "meta.json"))
                except OSError:
                    stale_meta_sha = None
                old_dir = os.path.join(
                    directory, ".ckpt-old-%s-%d-%d"
                    % (name, os.getpid(), time.time_ns()))
                os.rename(final_dir, old_dir)
            try:
                os.rename(tmp_dir, final_dir)
                break
            except OSError:
                # lost the commit race. Two distinct losers are possible
                # in a shared elastic directory:
                # (1) a concurrent latest_checkpoint() poll ran
                #     _adopt_aside_checkpoint between our two renames
                #     and resurrected OUR aside-moved stale dir — meta
                #     hash matches the one remembered above. Blessing it
                #     would silently drop the new snapshot in favor of
                #     pre-reform state: move it aside again and retry
                #     the commit.
                # (2) a concurrent same-name WRITER committed (every
                #     worker snapshots the same fixed-seed trajectory,
                #     so theirs is an EQUIVALENT snapshot — not
                #     byte-identical, to_tar stamps a creation time).
                #     Accept theirs only if it verifies.
                winner_sha = None
                try:
                    winner_sha = _sha256(
                        os.path.join(final_dir, "meta.json"))
                except OSError:
                    pass
                if (winner_sha is not None
                        and winner_sha == stale_meta_sha):
                    old_dir = None  # consumed by the adoption scan
                    continue
                if not verify_checkpoint(final_dir)[0]:
                    if old_dir is not None and not os.path.exists(final_dir):
                        try:  # failed commit: put the stale one back
                            os.rename(old_dir, final_dir)
                            old_dir = None
                        except OSError:
                            pass  # latest_checkpoint can still adopt it
                    raise
                shutil.rmtree(tmp_dir, ignore_errors=True)
                break
        else:
            raise OSError(
                "checkpoint commit of %s kept losing to concurrent "
                "adoption of its own replaced dir" % final_dir)
        if old_dir is not None:
            shutil.rmtree(old_dir, ignore_errors=True)
        _fsync_dir(directory)
    except Exception:
        import shutil

        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    _prune(directory, keep)
    logger.info("checkpoint saved: %s", final_dir)
    return final_dir


def _prune(directory, keep):
    import shutil

    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("pass-"))
    for stale in ckpts[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)
    # a crash mid-save (the chaos test's kill -9) strands a half-written
    # .ckpt-tmp-* dir (or an aside-moved .ckpt-old-* replaced commit);
    # sweep ones old enough that no live save owns them
    now = time.time()
    for name in os.listdir(directory):
        is_old = name.startswith(".ckpt-old-")
        if not (is_old or name.startswith(".ckpt-tmp-")):
            continue
        path = os.path.join(directory, name)
        try:
            if is_old:
                # os.rename preserves the dir's own mtime — that of the
                # ORIGINAL commit — so an aside of an hour-old
                # checkpoint would read as "stale" the instant it is
                # created, destroying the adoption target before a
                # resuming process can recover it. Age asides by the
                # move time encoded in their name instead.
                try:
                    age = now - int(name.rsplit("-", 1)[1]) / 1e9
                except (IndexError, ValueError):
                    age = now - os.path.getmtime(path)
            else:
                age = now - os.path.getmtime(path)
            if age > _STALE_TMP_SECS:
                logger.warning("removing stale checkpoint tmp dir %s "
                               "(crashed save)", path)
                shutil.rmtree(path, ignore_errors=True)
        except OSError:
            continue


def latest_checkpoint(directory):
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("pass-"))
    for name in reversed(ckpts):  # newest first; skip corrupt ones
        path = os.path.join(directory, name)
        ok, reason = verify_checkpoint(path)
        if ok:
            return path
        logger.warning("checkpoint %s fails integrity check (%s); "
                       "falling back to the previous one", path, reason)
    return _adopt_aside_checkpoint(directory)


def _adopt_aside_checkpoint(directory):
    """Last-resort recovery: a kill between save_checkpoint's two
    replacement renames leaves the (still intact) previous commit under
    ``.ckpt-old-<name>-<pid>-<ns>`` and nothing under its real name —
    if that was the ONLY checkpoint (keep=1, or the elastic step-0
    baseline), a plain scan finds nothing. Adopt the newest verifying
    aside dir by renaming it back before giving up."""
    asides = sorted(d for d in os.listdir(directory)
                    if d.startswith(".ckpt-old-"))
    for aside in reversed(asides):
        parts = aside[len(".ckpt-old-"):].rsplit("-", 2)
        if len(parts) != 3 or not parts[0].startswith("pass-"):
            continue
        src = os.path.join(directory, aside)
        if not verify_checkpoint(src)[0]:
            continue
        dst = os.path.join(directory, parts[0])
        try:
            os.rename(src, dst)
        except OSError:
            continue
        logger.warning("adopted aside checkpoint %s -> %s (crash during "
                       "a same-name replacement)", aside, parts[0])
        return dst
    return None


def verify_checkpoint(path):
    """Integrity check of one checkpoint directory. Returns ``(ok,
    reason)`` — ``reason`` names the failing file (missing/truncated
    meta.json, a payload listed in the manifest that is absent, or a
    sha256 mismatch from torn/corrupted bytes) so operators see WHAT
    broke, not just that something did."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return False, "meta.json missing (half-written checkpoint)"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as exc:
        return False, "meta.json unreadable: %s" % exc
    try:
        files = meta["files"]
    except (TypeError, KeyError):
        return False, "meta.json has no integrity manifest"
    if not isinstance(files, dict):
        return False, "meta.json integrity manifest is not a mapping"
    for fname, digest in files.items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            return False, "%s missing" % fname
        try:
            actual = _sha256(fpath)
        except OSError as exc:
            return False, "%s unreadable: %s" % (fname, exc)
        if actual != digest:
            return False, ("%s sha256 mismatch (truncated or corrupted)"
                           % fname)
    return True, "ok"


def _verify(path):
    return verify_checkpoint(path)[0]


def unflatten_state(template, flat, prefix=()):
    """Rebuild an optimizer-state pytree from the flat path->array dict,
    using ``template`` (e.g. optimizer.init_state(params)) for structure."""
    if isinstance(template, dict):
        return {k: unflatten_state(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(unflatten_state(v, flat, prefix + (str(i),))
                     for i, v in enumerate(template))
    if isinstance(template, list):
        return [unflatten_state(v, flat, prefix + (str(i),))
                for i, v in enumerate(template)]
    if template is not None and hasattr(template, "shape"):
        key = "/".join(prefix)
        if key not in flat and prefix[:1] == ("row_step",):
            # Checkpoints written before sparse mode was enabled (or before
            # a param gained sparse_update) have no row_step group. Backfill
            # with the restored GLOBAL step, not zeros: rows must read as
            # "last touched now", else the lazy L1/L2 catch-up would replay
            # the whole training history's decay on first touch.
            step = int(np.asarray(flat.get("step", 0)))
            return np.full(template.shape, step,
                           dtype=getattr(template, "dtype", np.int32))
        enforce(key in flat, "checkpoint optimizer state missing %r", key)
        return flat[key]
    return template


def load_checkpoint(path, with_opt_state=True):
    """Returns (parameters, opt_state_flat_or_None, meta). Integrity is
    re-verified (gob+MD5 parity — here sha256)."""
    ok, reason = verify_checkpoint(path)
    enforce(ok, "checkpoint %s failed integrity verification: %s", path,
            reason)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "parameters.tar"), "rb") as f:
        params = Parameters.from_tar(f, device="cpu")
    opt_flat = None
    opt_path = os.path.join(path, "optimizer.npz")
    if with_opt_state and os.path.exists(opt_path):
        import zipfile

        opt_flat = {}
        with zipfile.ZipFile(opt_path) as zf:
            for member in zf.namelist():
                arr = np.load(io.BytesIO(zf.read(member)), allow_pickle=False)
                opt_flat[member[:-4]] = arr  # strip .npy
    return params, opt_flat, meta


def checkpoint_bytes(path):
    """Total payload bytes of one checkpoint directory."""
    total = 0
    try:
        for name in os.listdir(path):
            total += os.path.getsize(os.path.join(path, name))
    except OSError:
        pass
    return total


class CheckpointSnapshot:
    """One consistent training-state snapshot handed from the step thread
    to the :class:`AsyncCheckpointer` writer.

    ``values`` is ``{"params", "state", "static", "opt"}`` of HOST
    tensors: the pinned copies of the step thread's device-side clone,
    their copy still in flight until ``event`` (a CUDA event, None on the
    CPU) has completed. ``rng`` is the trainer's generator state at the
    snapshot. ``parameters_template`` is a :meth:`Parameters.copy` taken
    at submit time, read for its specs only, so the writer thread makes no
    call on the card; ``unpool`` (optional) translates a pooled optimizer
    state back to the per-name wire format on the writer thread."""

    __slots__ = ("values", "event", "rng", "parameters_template", "unpool",
                 "step", "pass_id", "pass_cursor", "step_thread_ms",
                 "extra")

    def __init__(self, values, parameters_template, step, pass_id,
                 pass_cursor, rng=None, event=None, unpool=None,
                 step_thread_ms=None, extra=None):
        self.values = values
        self.event = event
        self.rng = rng
        self.parameters_template = parameters_template
        self.unpool = unpool
        self.step = int(step)
        self.pass_id = int(pass_id)
        self.pass_cursor = int(pass_cursor)
        self.step_thread_ms = step_thread_ms
        self.extra = extra


# what trainer_state["rng_kind"] says of a port checkpoint's rng_key: the
# bytes of the trainer's torch.Generator state (a JAX checkpoint stores a
# threefry key there and has no rng_kind)
RNG_KIND = "torch.Generator"


def trainer_state_meta(rng_key, pass_id, pass_cursor, step):
    """The ``extra_meta["trainer_state"]`` block a deterministic resume
    needs: the trainer's generator state AFTER ``step`` steps (a uint8
    tensor, stored as its bytes where the JAX package stores its
    threefry key), plus the reader position (pass id + batches consumed
    within it)."""
    return {
        "rng_key": [int(x) for x in to_numpy(rng_key).ravel()],
        "rng_kind": RNG_KIND,
        "pass": int(pass_id),
        "pass_cursor": int(pass_cursor),
        "step": int(step),
    }


class AsyncCheckpointer:
    """Overlapped checkpoint writer: serialization + fsync + atomic rename
    on ONE named daemon thread, newest-wins double buffering.

    ``submit()`` (the step-thread side) swaps the pending snapshot and
    returns immediately — if the writer is still committing an older one,
    the un-started pending snapshot is REPLACED (counted in
    ``superseded``), so a slow disk can never stall training. ``drain()``
    blocks until idle; ``close()`` drains, stops the thread and re-raises
    any write error so a checkpointing run cannot silently lose
    durability. ``saves``, ``superseded``, ``last_path``, ``last_step``
    and ``commits`` (one ``{"step", "path", "bytes", "writer_ms"}`` a
    commit) describe the commits."""

    def __init__(self, directory, keep=3, steplog=None,
                 metrics_registry=None):
        self.directory = directory
        self.keep = int(keep)
        self._steplog = steplog
        m = metrics_registry or observe_metrics.get_registry()
        self._m_saves = m.counter(
            "paddle_tpu_checkpoint_saves_total",
            help="checkpoints committed (atomic rename completed)")
        self._m_superseded = m.counter(
            "paddle_tpu_checkpoint_superseded_total",
            help="pending snapshots replaced by a newer one before the "
                 "writer could start them")
        self._m_bytes = m.counter(
            "paddle_tpu_checkpoint_bytes_total",
            help="bytes committed across all checkpoints")
        self._m_save_ms = m.histogram(
            "paddle_tpu_checkpoint_save_ms",
            help="writer-thread serialize+fsync+rename duration")
        self._cv = threading.Condition()
        self._pending = None
        self._writing = False
        self._stopped = False
        self._error = None
        self.saves = 0
        self.superseded = 0
        self.last_path = None
        self.last_step = None
        self.commits = []
        self._thread = threading.Thread(target=self._writer_loop,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    # -- step-thread side ---------------------------------------------------
    def submit(self, snapshot):
        """Hand one snapshot to the writer; returns True when it replaced
        an older not-yet-started pending snapshot (newest wins)."""
        with self._cv:
            if self._error is not None:
                raise self._error
            enforce(not self._stopped, "AsyncCheckpointer is closed")
            replaced = self._pending is not None
            self._pending = snapshot
            if replaced:
                self.superseded += 1
            self._cv.notify_all()
        if replaced:
            self._m_superseded.inc()
        return replaced

    def last_committed(self):
        """``(path, step)`` of the newest committed checkpoint, or
        ``(None, None)`` before the first commit."""
        with self._cv:
            return self.last_path, self.last_step

    def drain(self, timeout=None):
        """Block until the queue is empty and no write is in flight;
        re-raises a writer error."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while ((self._pending is not None or self._writing)
                   and self._error is None):
                remaining = (None if deadline is None
                             else max(deadline - time.time(), 0.0))
                if remaining == 0.0:
                    raise TimeoutError("checkpoint writer still busy "
                                       "after %.1fs" % timeout)
                self._cv.wait(remaining)
            if self._error is not None:
                raise self._error

    def close(self):
        """Drain, stop and join the writer thread; re-raises any write
        error. Raises TimeoutError if the writer is still mid-write after
        the join window."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
        with self._cv:
            if self._error is not None:
                raise self._error
        if self._thread.is_alive():
            raise TimeoutError(
                "checkpoint writer still busy 60s after close(); the "
                "final checkpoint under %s may not be committed"
                % self.directory)

    # -- writer thread ------------------------------------------------------
    def _writer_loop(self):
        if sys.platform.startswith("linux"):
            try:
                # Linux nice is per-thread (who=0 == the calling task):
                # serialization yields the CPU to the training loop
                os.setpriority(os.PRIO_PROCESS, 0, 10)
            except (AttributeError, OSError):
                pass
        while True:
            with self._cv:
                while self._pending is None and not self._stopped:
                    self._cv.wait()
                if self._pending is None and self._stopped:
                    return
                job, self._pending = self._pending, None
                self._writing = True
            try:
                self._write(job)
            except BaseException as exc:
                logger.exception("checkpoint write failed at step %d",
                                 job.step)
                with self._cv:
                    self._error = exc
                    self._cv.notify_all()
                return
            finally:
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()

    def _write(self, job):
        t0 = time.perf_counter()
        with observe_spans.span("checkpoint_write", args={"step": job.step}):
            if job.event is not None:
                job.event.synchronize()  # the device-to-host copy landed
            host = {k: _tree_numpy(v) for k, v in job.values.items()}
        template = job.parameters_template
        arrays = {**host.get("static", {}), **host["params"],
                  **host.get("state", {})}
        params = Parameters({n: torch.from_numpy(np.asarray(a))
                             for n, a in arrays.items()},
                            {n: template.spec(n) for n in arrays})
        opt_state = host.get("opt")
        if opt_state is not None and job.unpool is not None:
            opt_state = job.unpool(opt_state)
        extra = dict(job.extra or {})
        extra["trainer_state"] = trainer_state_meta(
            job.rng, job.pass_id, job.pass_cursor, job.step)
        path = save_checkpoint(
            self.directory, params, opt_state=opt_state, step=job.step,
            pass_id=job.pass_id, keep=self.keep, extra_meta=extra)
        duration_ms = (time.perf_counter() - t0) * 1e3
        nbytes = checkpoint_bytes(path)
        with self._cv:
            self.saves += 1
            self.last_path = path
            self.last_step = job.step
            self.commits.append({"step": job.step, "path": path,
                                 "bytes": nbytes, "writer_ms": duration_ms})
        self._m_saves.inc()
        self._m_bytes.inc(nbytes)
        self._m_save_ms.observe(duration_ms)
        if self._steplog is not None:
            log_commit(self._steplog, job.step, duration_ms, nbytes, True,
                       job.step_thread_ms, job.pass_id, path)


def log_commit(steplog, step, duration_ms, nbytes, overlapped,
               step_thread_ms, pass_id, path):
    """The steplog side of one committed checkpoint: the ``checkpoint``
    record and its ``checkpoint_commit`` elastic event (the commit a
    later rewind could target, observe/trainview.py)."""
    steplog.log_checkpoint(
        step=step, duration_ms=duration_ms, nbytes=nbytes,
        overlapped=overlapped, step_thread_ms=step_thread_ms,
        pass_id=pass_id, path=os.path.basename(path))
    steplog.log_elastic_event(
        "checkpoint_commit", worker=trainview.worker_id(), step=step,
        checkpoint=os.path.basename(path))


def _tree_numpy(tree):
    """A nested dict/tuple of tensors as the same structure of numpy."""
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tree_numpy(v) for v in tree)
    return to_numpy(tree)
