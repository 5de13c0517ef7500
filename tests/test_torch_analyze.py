"""The port's static analysis (paddle_tpu_torch/analyze) against the JAX
package's (paddle_tpu/analyze) on the CPU.

* The checkers: the JAX package's fixture sources for PTA003-007 and
  PTA009 (tests/test_analyze.py) give the same checker IDs and lines
  through both packages' ``lint_source``; PTA001, PTA002 and PTA008 read
  PyTorch hazards here, so each has PyTorch fixtures: it fires on its
  hazard, its sanctioned form is clean, and suppression works.
* The tree: the port's tree lints clean under all nine checkers, over
  more than 100 files (one full-tree run for the module), and every
  ``HOT_PATHS`` root names a function of the port.
* The reject_packed coverage: the port's derived sets equal the JAX
  package's, layer by layer.
* ``check_topology``, ``predict_jit_entries`` and ``_chunk_plan`` give the
  JAX package's answers on its own test topologies, and the chunk plan is
  the grouping the port's ``DeviceFeeder.chunks`` forms.
* The ``PADDLE_TPU_TORCH_ANALYZE`` hook, ``max_retraces``, ``cli
  analyze`` (JSON and exit codes, against the JAX CLI) and the pytest
  plugin (in a pytest subprocess of its own: tests/conftest.py registers
  the JAX package's gate for the suite).
"""

import json
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu import cli as jcli
from paddle_tpu.analyze import lint as jlint
from paddle_tpu.analyze import topology_check as jtc
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch.analyze import (RetraceBudgetExceeded, lint,
                                      max_retraces, topology_check)
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology

from torch_parity import both, numpy_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def _ids(findings):
    return [f.checker for f in findings]


def _id_lines(findings):
    return [(f.checker, f.line) for f in findings]


# -- the JAX package's fixtures: the same findings in both packages ----------

_PTA005_SRC = """
import threading
class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []
        self._stopped = False
    def submit(self, item):
        with self._lock:
            self._queue.append(item)
    def stop(self):
        with self._lock:
            self._stopped = True
    def live(self):
        return not self._stopped
"""

_PTA006_SRC = """
import threading
class A:
    def __init__(self):
        self._la = threading.Lock()
        self.peer = None
    def foo(self):
        with self._la:
            self.peer.bar_step()
    def foo_step(self):
        with self._la:
            pass
class B:
    def __init__(self):
        self._lb = threading.Lock()
        self.peer = None
    def bar(self):
        with self._lb:
            self.peer.foo_step()
    def bar_step(self):
        with self._lb:
            pass
"""

_PTA007_SRC = """
import threading
class W:
    def __init__(self):
        self._cv = threading.Condition()
        self._queue = []
    def take(self):
        with self._cv:
            if not self._queue:
                self._cv.wait()
            return self._queue.pop()
    def put(self, x):
        with self._cv:
            self._queue.append(x)
            self._cv.notify_all()
"""

_UNNAMED_THREAD = (
    "import threading\n"
    "def go(fn):\n"
    "    t = threading.Thread(target=fn, daemon=True)\n"
    "    t.start()\n")

_HEARTBEAT = (
    "import threading\n"
    "class WorkerSet:\n"
    "    def __init__(self):\n"
    "        self._hb = threading.Thread(\n"
    "            target=self._heartbeat_loop, daemon=True)\n"
    "        self._hb.start()\n"
    "    def _heartbeat_loop(self):\n"
    "        pass\n")

_HOST_WATCH = (
    "import threading\n"
    "class ClusterFront:\n"
    "    def __init__(self):\n"
    "        self._watch = threading.Thread(\n"
    "            target=self._watch_loop, daemon=True)\n"
    "        self._watch.start()\n"
    "    def _watch_loop(self):\n"
    "        pass\n")

_REGISTRY = (
    "import threading\n"
    "_lock = threading.Lock()\n"
    "_registry = {}\n"
    "def register(name, value):\n"
    "    _registry[name] = value\n"
    "def register_locked(name, value):\n"
    "    with _lock:\n"
    "        _registry[name] = value\n")

_WEAKSET = (
    "import threading\n"
    "import weakref\n"
    "_open = weakref.WeakSet()\n"
    "class Log:\n"
    "    def subscribe(self):\n"
    "        _open.add(self)\n")

_SUPPRESSED = (
    "import threading\n"
    "def go(fn):\n"
    "    t = threading.Thread(target=fn)  # paddle-lint: disable=PTA003\n")

_HELPER = (
    "import threading\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._n = 0\n"
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self._apply()\n"
    "    def _apply(self):\n"
    "        self._n += 1\n")

_MEMBERSHIP = (
    "import threading\n"
    "class Front:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._hosts = {}\n"
    "        self._ring = None\n"
    "    def _admit(self, host, entry):\n"
    "        with self._lock:\n"
    "            self._hosts[host] = entry\n"
    "            self._ring = tuple(self._hosts)\n"
    "    def dispatch(self, key):\n"
    "        return self._ring\n")

_SPANS = (
    "from paddle_tpu.observe import spans as observe_spans\n"
    "def work():\n"
    "    observe_spans.span('feed')\n"
    "    s = observe_spans.span('step')\n")

_SPANS_OK = (
    "from paddle_tpu.observe import spans as observe_spans\n"
    "def work():\n"
    "    with observe_spans.span('feed') as scope:\n"
    "        pass\n"
    "    return observe_spans.span('outer')\n")

_TRACE_CAPTURE = (
    "import threading\n"
    "from paddle_tpu.observe import tracing as observe_tracing\n"
    "def serve(trace):\n"
    "    ctx = observe_tracing.resolve(trace)\n"
    "    def worker():\n"
    "        use(ctx)\n"
    "    t = threading.Thread(target=worker, name='w')\n")

_TRACE_ARGS = (
    "import threading\n"
    "from paddle_tpu.observe import tracing as observe_tracing\n"
    "def serve(trace):\n"
    "    ctx = observe_tracing.resolve(trace)\n"
    "    def worker(c):\n"
    "        use(c)\n"
    "    t = threading.Thread(target=worker, name='w',\n"
    "                         args=(ctx,))\n")

_TRACE_LAMBDA = (
    "import threading\n"
    "def serve(trace):\n"
    "    t = threading.Thread(target=lambda: use(trace), name='w')\n")

# (case, path, source, the IDs both packages must give)
JAX_FIXTURES = [
    ("pta003_unnamed", "m.py", _UNNAMED_THREAD, ["PTA003"]),
    ("pta003_named", "m.py",
     _UNNAMED_THREAD.replace("daemon=True", "daemon=True, name='worker'"),
     []),
    ("pta003_heartbeat", "workers.py", _HEARTBEAT, ["PTA003"]),
    ("pta003_heartbeat_named", "workers.py",
     _HEARTBEAT.replace("daemon=True",
                        "daemon=True, name='serve-worker-heartbeat'"), []),
    ("pta003_host_watch", "cluster.py", _HOST_WATCH, ["PTA003"]),
    ("pta004_registry", "m.py", _REGISTRY, ["PTA004"]),
    ("pta004_no_threading", "m.py",
     _REGISTRY.replace("import threading\n", "", 1)
     .replace("threading.Lock()", "None"), []),
    ("pta004_weakset", "m.py", _WEAKSET, ["PTA004"]),
    ("suppressed_same_line", "m.py", _SUPPRESSED, []),
    ("suppressed_line_above", "m.py",
     "import threading\ndef go(fn):\n    # paddle-lint: disable=all\n"
     "    t = threading.Thread(target=fn)\n", []),
    ("suppressed_other_id", "m.py",
     _SUPPRESSED.replace("PTA003", "PTA001"), ["PTA003"]),
    ("pta005_unguarded", "m.py", _PTA005_SRC, ["PTA005"]),
    ("pta005_fixed", "m.py", _PTA005_SRC.replace(
        "        return not self._stopped",
        "        with self._lock:\n            return not self._stopped"), []),
    ("pta005_never_locked", "m.py", _PTA005_SRC.replace(
        "            self._stopped = True", "            pass"), []),
    ("pta005_suppressed", "m.py", _PTA005_SRC.replace(
        "        return not self._stopped",
        "        return not self._stopped  # paddle-lint: disable=PTA005"),
     []),
    ("pta005_helper", "m.py", _HELPER, []),
    ("pta005_helper_unlocked", "m.py",
     _HELPER + "    def bump_unlocked(self):\n        self._apply()\n",
     ["PTA005"]),
    ("pta005_membership", "cluster.py", _MEMBERSHIP, ["PTA005"]),
    ("pta005_snapshot", "cluster.py", _MEMBERSHIP.replace(
        "    def dispatch(self, key):\n        return self._ring\n",
        "    def _snapshot(self):\n        with self._lock:\n"
        "            return dict(self._hosts), self._ring\n"
        "    def dispatch(self, key):\n"
        "        hosts, ring = self._snapshot()\n        return ring\n"), []),
    ("pta006_inversion", "m.py", _PTA006_SRC, ["PTA006"]),
    ("pta006_fixed", "m.py", _PTA006_SRC.replace(
        "            self.peer.foo_step()", "            pass"), []),
    ("pta007_naked", "m.py", _PTA007_SRC, ["PTA007"]),
    ("pta007_while", "m.py", _PTA007_SRC.replace(
        "if not self._queue:", "while not self._queue:"), []),
    ("pta007_event", "m.py",
     "import threading\ndef go(proc):\n    ev = threading.Event()\n"
     "    ev.wait()\n    proc.wait()\n", []),
    ("pta009_not_entered", "m.py", _SPANS, ["PTA009", "PTA009"]),
    ("pta009_entered", "m.py", _SPANS_OK, []),
    ("pta009_closure", "m.py", _TRACE_CAPTURE, ["PTA009"]),
    ("pta009_args", "m.py", _TRACE_ARGS, []),
    ("pta009_lambda", "m.py", _TRACE_LAMBDA, ["PTA009"]),
    ("json_order", "m.py",
     "import threading\ndef go(fn):\n    threading.Thread(target=fn)\n"
     "    threading.Thread(target=fn)\n", ["PTA003", "PTA003"]),
]


@pytest.mark.parametrize("case,path,src,want", JAX_FIXTURES,
                         ids=[c[0] for c in JAX_FIXTURES])
def test_jax_fixtures_give_the_same_findings(case, path, src, want):
    got = lint.lint_source(src, path)
    assert _ids(got) == want
    assert _id_lines(got) == _id_lines(jlint.lint_source(src, path))
    assert [f.as_dict() for f in got] == [
        f.as_dict() for f in jlint.lint_source(src, path)
        if f.checker not in ("PTA001", "PTA002", "PTA008")]


def test_pta006_cross_module_cycle_inboth(tmp_path):
    a, b = tmp_path / "mod_a.py", tmp_path / "mod_b.py"
    head, tail = _PTA006_SRC.split("class B:")
    a.write_text(head)
    b.write_text("import threading\nclass B:" + tail)
    assert lint.lint_source(a.read_text(), str(a)) == []
    assert lint.lint_source(b.read_text(), str(b)) == []
    got = lint.lint_paths([str(a), str(b)])
    assert _ids(got) == ["PTA006"]
    assert _id_lines(got) == _id_lines(jlint.lint_paths([str(a), str(b)]))


def test_catalog_and_json_shape_are_the_jax_packages():
    assert sorted(lint.CHECKERS) == sorted(jlint.CHECKERS)
    assert {k: v[0] for k, v in lint.CHECKERS.items()} == {
        k: v[0] for k, v in jlint.CHECKERS.items()}
    f = lint.lint_source(_UNNAMED_THREAD, "m.py")[0]
    assert list(f.as_dict()) == ["file", "line", "id", "title", "message",
                                 "fixit"]
    assert lint.format_finding(f).splitlines()[0].endswith(
        "[PTA003 unmanaged-thread]")


# -- PTA001: host syncs, in PyTorch terms ------------------------------------

_SYNC_BODY = (
    "class SGD:\n"
    "    def _train_passes(self, feed):\n"
    "        loss, stats, finite = self._train_step(feed)\n"
    "        {stmt}\n"
    "        return loss\n")


@pytest.mark.parametrize("stmt,what", [
    ("x = float(loss)", "float()"),
    ("x = loss.item()", ".item()"),
    ("x = loss.tolist()", ".tolist()"),
    ("x = loss.cpu()", ".cpu()"),
    ("x = finite.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("self._done.synchronize()", "self._done.synchronize()"),
    ("x = np.asarray(stats)", "asarray()")])
def test_pta001_flags_each_host_sync_on_a_hot_path(stmt, what):
    src = _SYNC_BODY.format(stmt=stmt)
    got = lint.lint_source(src, "trainer.py")
    assert _id_lines(got) == [("PTA001", 4)]
    assert what in got[0].message
    # inside a span it is the sanctioned, measured sync point
    spanned = _SYNC_BODY.format(
        stmt="with observe_spans.span('eval_readback'):\n            "
        + stmt)
    assert lint.lint_source(spanned, "trainer.py") == []
    # a suppression on the line
    assert lint.lint_source(
        src.replace(stmt, stmt + "  # paddle-lint: disable=PTA001"),
        "trainer.py") == []
    # not a hot path file: not scanned
    assert lint.lint_source(src, "somewhere_else.py") == []


def test_pta001_tracks_iteration_taint_and_spares_host_arrays():
    src = (
        "class Bundle:\n"
        "    def run(self, flat, batch):\n"
        "        out = self._forward(batch)\n"
        "        return {k: np.asarray(v) for k, v in out.items()}\n")
    assert _id_lines(lint.lint_source(src, "serve/bundle.py")) == [
        ("PTA001", 4)]
    # a numpy array's methods read no device
    host = (
        "class Front:\n"
        "    def infer(self, arrays):\n"
        "        return {k: np.asarray(v).tolist() for k, v in arrays}\n")
    assert lint.lint_source(host, "serve/cluster.py") == []


def test_hot_path_roots_name_functions_of_the_port():
    """Every HOT_PATHS root is a function of the port (a copied table
    with dead roots would quietly guard less), and the worker's control
    verbs, the quantized forward and data parallelism's per-step work are
    among them."""
    import ast

    for suffix, names in lint.HOT_PATHS.items():
        path = os.path.join(PKG, suffix)
        assert os.path.isfile(path), suffix
        with open(path) as fh:
            tree = ast.parse(fh.read())
        defs = {n.name for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert names <= defs, (suffix, sorted(names - defs))
    assert set(lint.HOT_PATHS) == set(jlint.HOT_PATHS)
    assert {"_op_traces", "_op_history"} <= lint.HOT_PATHS["serve/workers.py"]
    assert "dequant_for_forward" in lint.HOT_PATHS["serve/quantize.py"]
    assert {"shard_batch", "all_reduce_"} <= lint.HOT_PATHS["parallel/mesh.py"]
    src = ("def all_reduce_(self, tensor):\n"
           "    out = _train_step(tensor)\n"
           "    return out.item()\n")
    assert _ids(lint.lint_source(src, "parallel/mesh.py")) == ["PTA001"]


# -- PTA002: capture and export busters --------------------------------------

_CAPTURE = (
    "import torch\n"
    "class SGD:\n"
    "    def _train_step(self, feed, share=None):\n"
    "        if share is not None:\n"
    "            pass\n"
    "        {stmt}\n"
    "        return feed\n"
    "    def _capture(self, chunk):\n"
    "        graph = torch.cuda.CUDAGraph()\n"
    "        with torch.cuda.graph(graph):\n"
    "            out = self._train_step(chunk.feed[0], None)\n"
    "        return graph\n")


@pytest.mark.parametrize("stmt,what", [
    ("if feed > 0:\n            feed = -feed", "branch on tensor argument"),
    ("while share:\n            share = share - 1",
     "branch on tensor argument"),
    ("n = int(feed)", "int() on tensor argument"),
    ("n = bool(share)", "bool() on tensor argument"),
    ("n = feed.item()", "item() on tensor argument")])
def test_pta002_flags_host_reads_inside_a_capture(stmt, what):
    src = _CAPTURE.format(stmt=stmt)
    got = lint.lint_source(src, "m.py")
    assert _id_lines(got) == [("PTA002", 6)]
    assert what in got[0].message and "_train_step" in got[0].message
    # the same function never captured is eager code: nothing to bust
    eager = src.replace("with torch.cuda.graph(graph):",
                        "with torch.no_grad():")
    assert lint.lint_source(eager, "m.py") == []
    assert lint.lint_source(
        src.replace(stmt.split("\n")[0], stmt.split("\n")[0]
                    + "  # paddle-lint: disable=PTA002"), "m.py") == []


_EXPORT = (
    "import torch\n"
    "class _Program(torch.nn.Module):\n"
    "    def __init__(self, fn):\n"
    "        super().__init__()\n"
    "        self.fn = fn\n"
    "    def forward(self, params, flat):\n"
    "        return self.fn(params, flat)\n"
    "def _make_forward(topology):\n"
    "    def forward(params, flat):\n"
    "        if flat is None:\n"
    "            return params\n"
    "        {stmt}\n"
    "        return flat\n"
    "    return forward\n"
    "def _export(fn, args):\n"
    "    return torch.export.export(_Program(fn), args)\n"
    "def export_bundle(topology):\n"
    "    forward = _make_forward(topology)\n"
    "    return _export(forward, (1, 2))\n")


def test_pta002_follows_the_function_handed_to_torch_export():
    """The exported function reaches torch.export.export through a module
    wrapper and a helper's parameter (serve/export.py's shape)."""
    src = _EXPORT.format(stmt="if flat:\n            return params")
    got = lint.lint_source(src, "m.py")
    assert _id_lines(got) == [("PTA002", 12)]
    assert "function 'forward'" in got[0].message
    assert lint.lint_source(_EXPORT.format(stmt="flat = flat * 2"),
                            "m.py") == []


@pytest.mark.parametrize("name,flagged", [
    ("'paddle_tpu_torch::lstm_seq_fwd'", False),
    ("f'paddle_tpu_torch::{kind}'", True),
    ("op_name", True)])
def test_pta002_custom_op_names_are_constants(name, flagged):
    src = ("import torch\n"
           "def register(kind, op_name):\n"
           "    @torch.library.custom_op(%s, mutates_args=())\n"
           "    def op(x: torch.Tensor) -> torch.Tensor:\n"
           "        return x.clone()\n"
           "    return op\n" % name)
    got = lint.lint_source(src, "ops/m.py")
    assert _id_lines(got) == ([("PTA002", 3)] if flagged else [])


# -- PTA008: a captured graph's static tensors after a later replay ----------

_REPLAY_READ = (
    "import torch\n"
    "def run(entry):\n"
    "    entry['graph'].replay()\n"
    "    out = {bind}\n"
    "    entry['graph'].replay()\n"
    "    return out\n")

_REPLAY_LOOP = (
    "def fused(entry, chunks, finalize):\n"
    "    pending = None\n"
    "    for chunk in chunks:\n"
    "        entry['graph'].replay()\n"
    "        if pending is not None:\n"
    "            finalize(pending)\n"
    "        pending = {bind}\n"
    "    return pending\n")

_REPLAY_COLLECT = (
    "def costs(entry, chunks):\n"
    "    kept = []\n"
    "    for chunk in chunks:\n"
    "        entry['graph'].replay()\n"
    "        kept.append({bind})\n"
    "    return kept\n")

_REPLAY_RETURN = (
    "class SGD:\n"
    "    def _replay(self, entry):\n"
    "        entry['graph'].replay()\n"
    "        return {bind}\n")

_CAPTURED = (
    "import torch\n"
    "def run(x):\n"
    "    graph = torch.cuda.CUDAGraph()\n"
    "    with torch.cuda.graph(graph):\n"
    "        static_out = x * 2\n"
    "    graph.replay()\n"
    "    first = {bind}\n"
    "    graph.replay()\n"
    "    return first + 0\n")


@pytest.mark.parametrize("src,line,what", [
    (_REPLAY_READ, 6, "read after its replay at line 5"),
    (_REPLAY_LOOP, 5, "in the next iteration"),
    (_REPLAY_COLLECT, 5, "collected inside a loop"),
    (_REPLAY_RETURN, 4, "returned uncopied from _replay()"),
    (_CAPTURED, 9, "read after its replay at line 8")],
    ids=["read", "loop", "collect", "return", "captured"])
def test_pta008_flags_static_tensors_read_after_a_replay(src, line, what):
    bind = "static_out" if src is _CAPTURED else "entry['out']"
    got = lint.lint_source(src.format(bind=bind), "trainer.py")
    assert _id_lines(got) == [("PTA008", line)]
    assert what in got[0].message
    # a clone before the next replay is the sanctioned form (the
    # trainer's _replay clones its outputs for exactly this reason)
    for copy in ("torch.clone(%s)", "_tree_map(torch.clone, %s)",
                 "%s.clone()"):
        assert lint.lint_source(src.format(bind=copy % bind),
                                "trainer.py") == []
    flagged = src.format(bind=bind).splitlines()
    flagged[line - 1] += "  # paddle-lint: disable=PTA008"
    assert lint.lint_source("\n".join(flagged) + "\n", "trainer.py") == []


# -- the port's tree ----------------------------------------------------------

@pytest.fixture(scope="module")
def port_tree():
    """ONE full-tree lint of the port for this module."""
    findings, n_files = lint.lint_tree()
    return {"findings": findings, "files": n_files}


def test_port_tree_lints_clean(port_tree):
    """The port's tree has no finding under the nine checkers: the nine
    it had under the JAX package's checkers are repaired (ops/_build.py's
    build log now written under its lock) or carry the JAX package's
    suppression with its reason."""
    assert port_tree["files"] > 100
    assert len(lint.CHECKERS) == 9
    assert port_tree["findings"] == [], "\n".join(
        lint.format_finding(f) for f in port_tree["findings"])
    assert port_tree["files"] == len(lint.tree_paths())
    assert not [p for p in lint.tree_paths()
                if "/build/" in p or "__pycache__" in p]


def test_build_logs_are_written_under_their_lock():
    """The repaired PTA004: build_all's threads record each build's
    compiler output under _build's log lock."""
    import ast

    from paddle_tpu_torch.ops import _build

    with open(_build.__file__) as fh:
        source = fh.read()
    assert lint.lint_source(source, "ops/_build.py") == []
    assert _ids(jlint.lint_source(source.replace(
        "    with _logs_lock:\n        build_logs[name] = proc.stdout",
        "    build_logs[name] = proc.stdout"), "ops/_build.py")) == [
        "PTA004"]
    assert isinstance(_build._logs_lock, type(_build._lock))
    tree = ast.parse(source)
    assert any(isinstance(n, ast.With)
               and any(getattr(i.context_expr, "id", None) == "_logs_lock"
                       for i in n.items)
               for n in ast.walk(tree))


# -- reject_packed coverage ---------------------------------------------------

def test_reject_packed_coverage_equals_the_jax_packages():
    cov, jcov = (topology_check.verify_reject_packed_coverage(),
                 jtc.verify_reject_packed_coverage())
    assert cov == jcov
    assert cov["missing"] == [] and cov["extra"] == []
    assert topology_check.packed_rejecting_node_types() == \
        jtc.packed_rejecting_node_types()
    info, jinfo = topology_check.scan_layer_modules(), jtc.scan_layer_modules()
    assert sorted(info) == sorted(jinfo)
    keys = ("node_type", "cross_position", "packing_aware", "rejects_packed")
    assert {n: [info[n][k] for k in keys] for n in info} == {
        n: [jinfo[n][k] for k in keys] for n in jinfo}


def test_scanner_reads_the_ports_idioms():
    """context_projection_layer delegates to mixed.py's projection object,
    whose forward hands the mask to seq_ops and calls reject_packed: read
    through it. multibox_loss hands the label's mask to det_ops, which
    reads it as one image's instance set: not a time-position signal."""
    info = topology_check.scan_layer_modules()
    cp = info["context_projection_layer"]
    assert cp["cross_position"] and cp["rejects_packed"]
    assert not info["multibox_loss"]["cross_position"]
    for name in ("lstmemory", "grumemory", "recurrent"):
        assert info[name]["cross_position"] and info[name]["packing_aware"]


# -- topology checks ----------------------------------------------------------

def _tagging(pkg, vocab=30, labels=5, hidden=8):
    L, dt = pkg.layer, pkg.data_type
    word = L.data(name="word", type=dt.integer_value_sequence(vocab))
    emb = L.embedding(input=word, size=6)
    proj = L.fc(input=emb, size=3 * hidden)
    fwd = L.grumemory(input=proj, size=hidden)
    scores = L.fc(input=fwd, size=labels)
    label = L.data(name="label", type=dt.integer_value_sequence(labels))
    return L.classification_cost(input=scores, label=label)


def _pooled(pkg):
    L, dt = pkg.layer, pkg.data_type
    word = L.data(name="word", type=dt.integer_value_sequence(20))
    pooled = L.pooling(input=L.embedding(input=word, size=4),
                       pooling_type=pkg.pooling.AvgPooling())
    y = L.data(name="y", type=dt.dense_vector(1))
    return L.square_error_cost(input=L.fc(input=pooled, size=1), label=y)


def _raw_ids(pkg):
    L, dt = pkg.layer, pkg.data_type
    ids = L.data(name="ids", type=dt.integer_value(50))
    y = L.data(name="y", type=dt.dense_vector(1))
    return L.square_error_cost(input=L.fc(input=ids, size=1), label=y)


def _embedded_ids(pkg):
    L, dt = pkg.layer, pkg.data_type
    ids = L.data(name="ids", type=dt.integer_value(50))
    y = L.data(name="y", type=dt.dense_vector(1))
    return L.square_error_cost(
        input=L.fc(input=L.embedding(input=ids, size=4), size=1), label=y)


def _shared_label(pkg):
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(4))
    y = L.data(name="y", type=dt.dense_vector(1))
    out = L.fc(input=x, size=1)
    merged = L.fc(input=[out, L.fc(input=y, size=1)], size=1)
    return L.square_error_cost(input=merged, label=y)


def _dense(pkg):
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(6))
    y = L.data(name="y", type=dt.dense_vector(1))
    out = L.fc(input=L.fc(input=x, size=6), size=1)
    return L.square_error_cost(input=out, label=y)


@pytest.mark.parametrize("build,with_params", [
    (_tagging, False), (_pooled, False), (_raw_ids, False),
    (_embedded_ids, False), (_shared_label, False), (_dense, True),
    (_tagging, True)],
    ids=["tagging", "pooling", "index_promotion", "embedded_ids",
         "shared_label", "dense_partition", "tagging_partition"])
def test_check_topology_gives_the_jax_report(build, with_params):
    jcost, cost = both(build)
    kw, jkw = {}, {}
    if with_params:
        kw = {"parameters": Parameters.create(cost, device="cpu"),
              "steps_per_call": 4}
        jkw = {"parameters": jpaddle.parameters.Parameters.create(jcost),
               "steps_per_call": 4}
    report = topology_check.check_topology(Topology(cost), **kw)
    jreport = jtc.check_topology(JaxTopology(jcost), **jkw)
    assert report == jreport
    assert topology_check.format_report(report) == jtc.format_report(
        jreport)


def test_check_topology_replica_under_a_bf16_compute_dtype():
    from paddle_tpu.core import dtype as jdtype
    from paddle_tpu_torch.core import dtype as pdtype

    jcost, cost = both(_dense)
    reports = []
    for mod, check, topo, params in (
            (pdtype, topology_check.check_topology, Topology(cost),
             Parameters.create(cost, device="cpu")),
            (jdtype, jtc.check_topology, JaxTopology(jcost),
             jpaddle.parameters.Parameters.create(jcost))):
        mod.set_mixed_precision("bfloat16")
        try:
            reports.append(check(topo, parameters=params))
        finally:
            mod.set_mixed_precision(None)
    assert reports[0] == reports[1]
    assert reports[0]["donation"]["replica"] is True


# -- program prediction -------------------------------------------------------

def _dense_batches(n_batches, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(6).astype(np.float32),
              np.array([rng.randn()], np.float32))
             for _ in range(batch)] for _ in range(n_batches)]


def _seq_samples(n, seed=0, vocab=30, labels=5,
                 lengths=(2, 3, 4, 9, 10, 18)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.choice(lengths))
        out.append((rng.randint(0, vocab, ln).astype(np.int32).tolist(),
                    rng.randint(0, labels, ln).astype(np.int32).tolist()))
    return out


BUCKETS = [4, 10, 20]


def _tagging_reader(pkg, samples):
    return pkg.minibatch.batch(lambda: iter(samples), 8)


def test_chunk_plan_is_the_jax_packages():
    keys = ["a", "a", "a", "a", "a", "b", "b", "a"]
    for k in (1, 2, 4):
        assert list(topology_check._chunk_plan(keys, k)) == list(
            jtc._chunk_plan(keys, k))
    assert list(topology_check._chunk_plan(keys, 4)) == [
        ("a", 4), ("a", 1), ("b", 2), ("a", 1)]
    assert list(topology_check._chunk_plan([], 4)) == []


@pytest.mark.parametrize("k,programs", [(None, 1), (1, 1), (4, 2)])
def test_predict_jit_entries_dense_equals_jax(k, programs):
    data = _dense_batches(9)
    jcost, cost = both(_dense)
    pred = topology_check.predict_jit_entries(
        Topology(cost), lambda: iter(data), steps_per_call=k)
    jpred = jtc.predict_jit_entries(
        JaxTopology(jcost), lambda: iter(data), steps_per_call=k)
    assert pred == jpred
    assert pred["programs"] == programs


@pytest.mark.parametrize("k", [None, 4])
def test_predict_jit_entries_bucketed_tagging_equals_jax(k):
    samples = _seq_samples(64, seed=9)
    jcost, cost = both(_tagging)
    buckets = {"boundaries": BUCKETS, "drop_remainder": True}
    pred = topology_check.predict_jit_entries(
        Topology(cost), _tagging_reader(paddle, samples), buckets=buckets,
        steps_per_call=k)
    jpred = jtc.predict_jit_entries(
        JaxTopology(jcost), _tagging_reader(jpaddle, samples),
        buckets=buckets, steps_per_call=k)
    assert pred == jpred
    for entry in pred["entries"]:
        assert set(entry["seq_pad"].values()) <= set(BUCKETS)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_chunk_plan_is_the_feeders_grouping(k):
    """The prediction's chunk plan is what DeviceFeeder.chunks forms over
    the same bucketed stream on the CPU: steps, rows and padded length,
    chunk by chunk."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.data import bucketing
    from paddle_tpu_torch.data.feeder import DeviceFeeder

    samples = _seq_samples(96, seed=4)
    reset_name_counters()
    topo = Topology(_tagging(paddle))
    reader = bucketing.rebucket_batches(
        _tagging_reader(paddle, samples), buckets=BUCKETS,
        drop_remainder=False,
        length_of=bucketing.topology_length_of(topo, None))
    feeder = DeviceFeeder(reader, topo, depth=2, device="cpu")
    formed = []
    for chunk in feeder.chunks(k):
        feed = chunk.batches[0].feed
        assert isinstance(feed["word"], SequenceBatch)
        formed.append(((chunk.batches[0].examples,
                        (("word", int(feed["word"].data.shape[1])),
                         ("label", int(feed["label"].data.shape[1])))),
                       chunk.steps))
    keys = []
    for batch in reader():
        keys.append((len(batch), (("word", int(batch.bucket)),
                                  ("label", int(batch.bucket)))))
    assert formed == list(topology_check._chunk_plan(keys, k))
    pred = topology_check.predict_jit_entries(
        topo, _tagging_reader(paddle, samples), buckets=BUCKETS,
        steps_per_call=k)
    kinds = {("scan" if steps > 1 else "step", key[0], dict(key[1])["word"],
              steps if steps > 1 else None)
             for key, steps in formed}
    assert kinds == {(e["kind"], e["rows"], e["seq_pad"]["word"],
                      e.get("steps")) for e in pred["entries"]}


# -- the hook, the budget -----------------------------------------------------

def _trainer(build=_dense):
    reset_name_counters()
    cost = build(paddle)
    specs = Topology(cost).param_specs()
    params = Parameters({k: torch.from_numpy(v) for k, v in
                         numpy_params(specs, 3).items()}, specs)
    return paddle.trainer.SGD(cost, params, paddle.optimizer.Momentum(
        learning_rate=1e-2, momentum=0.9), device="cpu")


def _costs(trainer, data, **kw):
    costs = []
    trainer.train(lambda: iter(data), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle.event.EndIteration) else None,
                  **kw)
    return costs


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def port_log():
    from paddle_tpu_torch.utils.logger import logger

    handler = _Records()
    logger.addHandler(handler)
    try:
        yield handler.lines
    finally:
        logger.removeHandler(handler)


def test_analyze_hook_observes_only(monkeypatch, port_log):
    """Under PADDLE_TPU_TORCH_ANALYZE=1 the trainer runs pretrain_check
    once before the first dispatch and trains bit for bit as without it;
    a topology warning is logged."""
    data = _dense_batches(5)
    plain = _costs(_trainer(), data, steps_per_call=2)
    seen = []
    real = topology_check.pretrain_check
    monkeypatch.setattr(topology_check, "pretrain_check",
                        lambda tr, steps_per_call=None: seen.append(
                            (tr._step_count, steps_per_call))
                        or real(tr, steps_per_call))
    monkeypatch.setenv("PADDLE_TPU_TORCH_ANALYZE", "1")
    hooked = _costs(_trainer(), data, steps_per_call=2)
    assert hooked == plain
    assert seen == [(0, 2)]
    with max_retraces(0):  # eager steps on the CPU capture nothing
        _costs(_trainer(), data)
    topology_check.pretrain_check(_trainer(_raw_ids))
    assert any("promote to float" in line for line in port_log)


def test_analyze_hook_raises_before_the_first_dispatch(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_ANALYZE", "1")
    tr = _trainer()
    trainable, static, state = tr.parameters.partition()
    monkeypatch.setattr(Parameters, "partition", lambda self: (
        trainable, static + trainable[:1], state))
    with pytest.raises(ValueError, match="in both the static and "
                       "trainable carries"):
        tr.train(lambda: iter(_dense_batches(2)), num_passes=1)
    assert tr._step_count == 0


def test_pretrain_check_warns_over_the_budget(monkeypatch, port_log):
    tr = _trainer()
    monkeypatch.setenv("PADDLE_TPU_TORCH_HBM_BUDGET", "1")
    report = topology_check.pretrain_check(tr)
    assert report["hbm"]["params"] > 0
    assert any("PADDLE_TPU_TORCH_HBM_BUDGET" in w for w in report["warnings"])
    assert any("PADDLE_TPU_TORCH_HBM_BUDGET" in line for line in port_log)
    assert "hbm estimate" in topology_check.format_report(report)
    monkeypatch.setenv("PADDLE_TPU_TORCH_HBM_BUDGET", "1G")
    report = topology_check.pretrain_check(tr)
    assert not any("PADDLE_TPU_TORCH_HBM_BUDGET" in w
                   for w in report["warnings"])


def test_max_retraces_counts_captures_and_loads():
    """The budget counts the capture and program-load events
    (observe/steplog.watch_compiles) on any thread, and raises over it."""
    import threading

    def capture():
        steplog.emit_event("/paddle_tpu_torch/cuda_graph_capture", 0.01)

    with max_retraces(2) as watcher:
        capture()
        t = threading.Thread(target=capture, name="capture-probe")
        t.start()
        t.join()
    assert watcher.compiles == 2
    with pytest.raises(RetraceBudgetExceeded, match="budget 1"):
        with max_retraces(1):
            capture()
            steplog.emit_event("/paddle_tpu_torch/program_load", 0.01)
    with max_retraces(0) as watcher:
        steplog.emit_event("/paddle_tpu_torch/kernel_load/lstm", 0.01)
    assert watcher.compiles == 0


# -- cli analyze --------------------------------------------------------------

def _run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


BAD = ("import threading\n"
       "def go(fn):\n"
       "    threading.Thread(target=fn)\n")


@pytest.mark.parametrize("fmt", [["--format=json"], ["--json"], []])
def test_cli_analyze_planted_finding_equals_jax(tmp_path, capsys, fmt):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    rc, out = _run_cli(cli.main, ["analyze", str(bad)] + fmt, capsys)
    jrc, jout = _run_cli(jcli.main, ["analyze", str(bad)] + fmt, capsys)
    assert rc == jrc == 1
    assert out == jout
    if fmt:
        got = json.loads(out)
        assert [f["id"] for f in got["findings"]] == ["PTA003"]
        assert list(got["findings"][0]) == ["file", "line", "id", "title",
                                            "message", "fixit"]
        assert got["checkers"] == sorted(lint.CHECKERS)


@pytest.mark.parametrize("fmt", [["--all", "--json"], ["--all"]])
def test_cli_analyze_clean_tree(monkeypatch, capsys, port_tree, fmt):
    """``analyze --all`` over the port's tree (the module's one lint run)
    exits 0: JSON of the JAX CLI's shape, or the clean line."""
    monkeypatch.setattr(lint, "lint_tree", lambda root=None: (
        port_tree["findings"], port_tree["files"]))
    rc, out = _run_cli(cli.main, ["analyze"] + fmt, capsys)
    assert rc == 0
    if "--json" in fmt:
        got = json.loads(out)
        assert list(got) == ["files", "checkers", "findings",
                             "reject_packed"]
        assert got["files"] == port_tree["files"] and got["findings"] == []
        assert got["reject_packed"] == jtc.verify_reject_packed_coverage()
    else:
        assert out.strip() == (
            "analyze clean: %d files, 9 checkers, reject_packed coverage "
            "14/14 layers" % port_tree["files"])


def test_cli_analyze_topology_needs_config(capsys):
    assert cli.main(["analyze", "--topology"]) == 2
    assert jcli.main(["analyze", "--topology"]) == 2
    assert capsys.readouterr().err.count(
        "analyze --topology needs --config") == 2


V2_CONFIG = textwrap.dedent('''
    import numpy as np
    import {pkg} as paddle
    from {pkg} import layer as L, data_type as dt, optimizer as opt

    batch_size = 8


    def cost():
        word = L.data(name="word", type=dt.integer_value_sequence(30))
        emb = L.embedding(input=word, size=6)
        proj = L.fc(input=emb, size=24)
        fwd = L.grumemory(input=proj, size=8)
        scores = L.fc(input=fwd, size=5)
        label = L.data(name="label", type=dt.integer_value_sequence(5))
        return L.classification_cost(input=scores, label=label)


    def optimizer():
        return opt.Adam(learning_rate=1e-2)


    def train_reader():
        def reader():
            rng = np.random.RandomState(9)
            for _ in range(64):
                n = int(rng.choice([2, 3, 4, 9, 10, 18]))
                yield (rng.randint(0, 30, n).tolist(),
                       rng.randint(0, 5, n).tolist())
        return reader
''')


@pytest.mark.parametrize("fmt", [["--format", "json"], []])
def test_cli_analyze_topology_equals_jax(tmp_path, capsys, fmt):
    reports = []
    for pkg, main in (("paddle_tpu_torch", cli.main),
                      ("paddle_tpu", jcli.main)):
        conf = tmp_path / ("conf_%s.py" % pkg)
        conf.write_text(V2_CONFIG.format(pkg=pkg))
        reports.append(_run_cli(main, [
            "analyze", "--topology", "--config", str(conf), "--buckets",
            "4,10,20", "--steps-per-call", "4"] + fmt, capsys))
    (rc, out), (jrc, jout) = reports
    assert rc == jrc == 0
    assert out == jout
    if fmt:
        report = json.loads(out)
        assert report["jit_entries"]["programs"] >= 3
        assert report["donation"]["steps_per_call"] == 4


# -- the pytest plugin --------------------------------------------------------

PLUGIN_TESTS = '''
import threading

import pytest


def _leak():
    stop = threading.Event()
    threading.Thread(target=stop.wait, args=(30,), name="leaky-probe",
                     daemon=True).start()


def test_leaks():
    _leak()


@pytest.mark.allow_thread_leaks
def test_leaks_allowed():
    _leak()


def test_budget(max_retraces):
    from paddle_tpu_torch.observe import steplog

    with max_retraces(1) as w:
        steplog.emit_event("/paddle_tpu_torch/cuda_graph_capture", 0.0)
    assert w.compiles == 1


@pytest.mark.analyze_tree
def test_marker_is_registered():
    pass
'''


def test_pytest_plugin_gates_a_leaking_test(tmp_path):
    """Loaded with -p, the plugin fails a test that leaks a thread,
    passes it under allow_thread_leaks, and serves the max_retraces
    fixture and its markers."""
    (tmp_path / "test_probe.py").write_text(PLUGIN_TESTS)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "--noconftest",
         "-W", "error::pytest.PytestUnknownMarkWarning",
         "-p", "paddle_tpu_torch.analyze.pytest_plugin", "-rfE",
         str(tmp_path / "test_probe.py")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    out = proc.stdout + proc.stderr
    # the gate fails the leaking test at its teardown
    assert proc.returncode == 1, out
    assert "4 passed, 1 error" in out, out
    assert "ERROR test_probe.py::test_leaks " in out, out
    assert "leaked 1 thread(s): ['leaky-probe']" in out, out
