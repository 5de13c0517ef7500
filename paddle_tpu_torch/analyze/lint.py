"""Framework-aware AST lint over the port's source tree
(paddle_tpu/analyze/lint.py, with the hazards read in PyTorch terms).

Each checker encodes one hazard class, with an ID, a fix-it hint and an
inline suppression syntax. The IDs and titles are the JAX package's:

* **PTA001 host-sync-in-hot-path** — ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()`` or an Event's or
  Stream's ``.synchronize()``, or ``float()/int()/np.asarray()/
  np.array()`` on a value returned by a device step (``DEVICE_CALLS``),
  reachable from a known hot path (``HOT_PATHS``: the trainer's step
  loops, the serving engine and bundle, the feeder threads) and NOT
  inside an ``observe_spans.span(...)`` block. Spans are the sanctioned
  materialization points: a sync inside one is measured and deliberate;
  a sync outside one silently serializes the host with the card.
* **PTA002 jit-cache-buster** — here a capture or export buster. The
  bodies checked are those the port captures or exports: the statements
  inside ``with torch.cuda.graph(...)`` and the functions they call, and
  the functions handed to ``torch.export.export`` (directly, through a
  module wrapper, or through a helper's parameter). Inside them, a
  Python ``if``/``while`` whose test is a tensor parameter (a host sync
  that breaks a capture, or a guard that re-exports per value; ``is
  None`` tests are structure, and exempt), and ``bool()/float()/int()``
  or ``.item()`` on a tensor parameter. Outside them, a non-constant name
  (an f-string, a variable) handed to ``torch.library.custom_op`` /
  ``define``: a fresh op per call.
* **PTA003 unmanaged-thread** — ``threading.Thread(...)`` without a
  ``name=``. Anonymous threads defeat the thread-leak gate
  (analyze/pytest_plugin.py) and every postmortem.
* **PTA004 unlocked-registry** — in a module that uses threading:
  mutation of a module-level container outside a ``with <module-lock>:``
  block.
* **PTA009 span-hygiene** — a ``span(...)`` call that is a bare
  statement or an assignment (never entered, so it times nothing), and a
  ``threading.Thread(target=...)`` whose target closure-captures a trace
  context instead of taking it by value.

PTA005-008 (unguarded shared state, lock-order inversion, naked
condition waits, and PTA008 — on the port a read of a captured CUDA
graph's static tensors after a later replay overwrote them) are the
interprocedural checkers of analyze/concurrency.py; they run through the
same drivers, IDs and suppressions. PTA006 builds its lock-acquisition
graph across every linted file, so ``lint_paths``/``lint_tree`` see
cross-module cycles a per-file lint cannot.

Suppression: append ``# paddle-lint: disable=PTA001`` (comma-separate
multiple IDs, or ``disable=all``) to the flagged line or the line just
above it. Suppressions are line-scoped: a file-wide opt-out would rot.

The port's tree lints clean (tests/test_torch_analyze.py pins it).
"""

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass

# -- catalog -----------------------------------------------------------------

CHECKERS = {
    "PTA001": ("host-sync-in-hot-path",
               "materialize inside an observe_spans.span(...) block (the "
               "measured, sanctioned sync point) or keep the value on the "
               "device"),
    "PTA002": ("jit-cache-buster",
               "branch on the device (torch.where, masks) or on host "
               "(non-tensor) arguments inside captured or exported code, "
               "and give custom ops constant names"),
    "PTA003": ("unmanaged-thread",
               "name the thread and reuse the cancellation idiom "
               "(data/feeder.py: named daemon thread + "
               "reader.decorator._cancellable_put/_drain)"),
    "PTA004": ("unlocked-registry",
               "guard the mutation with the module's lock (add a "
               "module-level threading.Lock() if the module has none)"),
    "PTA005": ("unguarded-shared-state",
               "take the guarding lock around the access (or snapshot "
               "the value under the lock and use the snapshot)"),
    "PTA006": ("lock-order-inversion",
               "acquire the locks in one global order everywhere, or "
               "drop one of them (snapshot under the first lock, call "
               "out after releasing it)"),
    "PTA007": ("naked-condition-wait",
               "wrap the wait in `while <predicate>:` — a woken waiter "
               "must re-test its predicate (see engine._take_batch)"),
    "PTA008": ("use-after-donate",
               "clone the graph's static tensors before its next replay "
               "(torch.clone), or bind them again after that replay"),
    "PTA009": ("span-hygiene",
               "enter spans with `with ...span(...):` (a span call that "
               "is never entered times nothing), and hand trace "
               "contexts to threads as explicit args=/queue items — "
               "closure capture hides the hop from the trace lane"),
}

# Hot-path roots for PTA001, keyed by path suffix (the JAX package's
# table, each root a function of the port). Nested closures (e.g. the
# trainer's per-pass ``finalize``) are scanned as part of their enclosing
# hot function.
HOT_PATHS = {
    "trainer.py": {"_train_passes", "_train_passes_fused", "test"},
    "serve/engine.py": {"submit", "_take_batch", "_loop", "_run_batch"},
    "serve/bundle.py": {"run", "infer", "warmup", "decode_step"},
    "serve/scheduler.py": {"submit", "_loop", "_run_iteration",
                           "_distribute", "_plan", "_swap_writer_loop"},
    # the session page file sits on the spill-writer and admission
    # paths: every put/pop/eviction scan runs per swap under load
    "serve/sessions.py": {"put", "pop", "touch", "gone_reason",
                          "_pick_victim_locked", "order"},
    "serve/router.py": {"submit", "total_queued"},
    "serve/fleet.py": {"submit", "queue_depth", "_eligible",
                       "_route_session"},
    # the multi-process data plane's ring + dispatch, and the worker's
    # traces/history control verbs (host dict copies by contract)
    "serve/workers.py": {"put_frames", "get", "submit", "_submit_to",
                         "_eligible", "_route_session", "_rx_loop",
                         "_dispatch_response", "queue_depth",
                         "_op_traces", "_op_history"},
    # the fleet-of-fleets front: dispatch walks the ring and relays
    # frames per request
    "serve/cluster.py": {"dispatch_payload", "_candidates", "_snapshot",
                         "_note_landing", "infer"},
    # the remote session store: every spill/restore of every host in
    # the cluster crosses these
    "serve/remote_store.py": {"put", "pop", "gone_reason", "_call",
                              "_dispatch"},
    # request-scoped tracing rides every serving submit/retire
    "observe/tracing.py": {"resolve", "sample", "offer"},
    # the windowed health recorder rides the same submit/retire paths
    "observe/health.py": {"record_request", "record_shed",
                          "record_queue_depth", "record_occupancy",
                          "snapshot"},
    # the training-side twin, inside the trainer's per-step finalize
    "observe/trainview.py": {"record_step", "record_chunk",
                             "record_checkpoint", "snapshot"},
    # the elastic driver's membership-watch handler runs at every step
    # boundary, nested inside run_elastic
    "distributed/elastic.py": {"run_elastic"},
    # the quantized dequant runs at the top of every quantized forward,
    # inside the exported programs (serve/export.py) and Bundle.run
    "serve/quantize.py": {"dequant_for_forward", "dequantize"},
    "data/feeder.py": {"_produce", "batches", "chunks"},
    # the async checkpoint writer: submit runs on the step thread
    "distributed/checkpoint.py": {"submit", "drain", "_writer_loop",
                                  "_write"},
    # the cluster worker's train loop and data parallelism's per-step
    # work: the batch split, the gradient all-reduces, the batch scope
    "distributed/worker.py": {"main"},
    "parallel/mesh.py": {"shard_batch", "all_reduce_", "batch_scope"},
    # the SLO controller's decide/apply cycle takes the engines' locks
    "control/controller.py": {"step", "_judge_pending_locked",
                              "_decide_locked"},
}

# Calls whose results are device tensors: reading them back with
# float()/np.asarray() outside a span is the PTA001 hazard.
DEVICE_CALLS = {"_train_step", "_train_chunk", "_replay", "_forward", "run",
                "decode_step"}

# Host-materializing wrappers that flag when applied to a device value.
SYNC_WRAPPERS = {"float", "int", "asarray", "array", "atleast_1d"}

# Tensor methods that copy to the host (and so wait for the card).
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

MUTATORS = {"add", "append", "appendleft", "extend", "insert", "remove",
            "discard", "pop", "popleft", "clear", "update", "setdefault"}
CONTAINER_CTORS = {"set", "dict", "list", "deque", "defaultdict",
                   "OrderedDict", "Counter", "WeakSet",
                   "WeakValueDictionary", "WeakKeyDictionary"}
LOCK_CTORS = {"Lock", "RLock", "Condition"}

_SUPPRESS_RE = re.compile(
    r"#\s*paddle-lint:\s*disable=([A-Za-z0-9_,\s]+|all)")


@dataclass
class Finding:
    checker: str
    path: str
    line: int
    message: str

    @property
    def hint(self):
        return CHECKERS[self.checker][1]

    @property
    def title(self):
        return CHECKERS[self.checker][0]

    def as_dict(self):
        """One finding as the ``cli analyze --format=json`` record. The
        key set and order are the JAX package's."""
        return {"file": self.path, "line": self.line, "id": self.checker,
                "title": self.title, "message": self.message,
                "fixit": self.hint}


def format_finding(f):
    return "%s:%d: %s [%s %s]\n    fix: %s" % (
        f.path, f.line, f.message, f.checker, f.title, f.hint)


# -- suppression -------------------------------------------------------------

def _suppressions(source):
    """{line_number: set of suppressed checker ids (or {"all"})} from
    ``# paddle-lint: disable=...`` comments."""
    out = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out.setdefault(tok.start[0], set()).update(
                {"all"} if "all" in ids else ids)
    except tokenize.TokenError:
        pass
    return out


def _suppressed(finding, suppressions):
    for line in (finding.line, finding.line - 1):
        ids = suppressions.get(line)
        if ids and ("all" in ids or finding.checker in ids):
            return True
    return False


# -- shared AST helpers ------------------------------------------------------

def _call_name(func):
    """Trailing identifier of a call target: Name or Attribute."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _dotted(node):
    """'torch.cuda.graph' / 'x' for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return base + "." + node.attr if base else None
    return None


def _names_in(node):
    """All Name identifiers in a subtree."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_span_with(node):
    """True for ``with ...span(...):`` — the sanctioned sync scope."""
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and _call_name(expr.func) == "span":
            return True
    return False


def _is_graph_capture(expr):
    """True for ``torch.cuda.graph(...)`` (any alias ending ``cuda.graph``
    or a bare ``graph`` imported from torch.cuda)."""
    if not isinstance(expr, ast.Call):
        return False
    name = _dotted(expr.func)
    return bool(name) and (name.endswith("cuda.graph") or name == "graph")


# -- PTA001: host sync in hot path -------------------------------------------

class _HotPathChecker(ast.NodeVisitor):
    def __init__(self, path, findings):
        self.path = path
        self.findings = findings
        self.tracked = set()
        self.span_depth = 0

    def run(self, func_node):
        self._collect_tracked(func_node)
        for stmt in func_node.body:
            self.visit(stmt)

    def _collect_tracked(self, func_node):
        """Names bound (directly or via iteration) to device-step
        results. Two passes so iteration taint over a tracked name
        (``for k, v in out.items():``) resolves."""
        for _ in range(2):
            for node in ast.walk(func_node):
                if isinstance(node, ast.Assign):
                    if self._is_device_call(node.value):
                        for t in node.targets:
                            self.tracked |= _names_in(t)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    it = node.iter
                    if _names_in(it) & self.tracked:
                        self.tracked |= _names_in(node.target)

    def _is_device_call(self, value):
        return (isinstance(value, ast.Call)
                and _call_name(value.func) in DEVICE_CALLS)

    def visit_With(self, node):
        if _is_span_with(node):
            self.span_depth += 1
            for stmt in node.body:
                self.visit(stmt)
            self.span_depth -= 1
        else:
            self.generic_visit(node)

    def visit_Call(self, node):
        if self.span_depth == 0:
            name = _call_name(node.func)
            if name in SYNC_METHODS and isinstance(node.func, ast.Attribute) \
                    and not _is_host_array(node.func.value):
                self._flag(node, ".%s() copies to the host" % name)
            elif name == "synchronize":
                self._flag(node, "%s() waits for the card"
                           % (_dotted(node.func) or name))
            elif name in SYNC_WRAPPERS and node.args:
                hit = _names_in(node.args[0]) & self.tracked
                if hit:
                    self._flag(node, "%s() on device value %r reads it "
                               "back to the host" % (name, sorted(hit)[0]))
        self.generic_visit(node)

    def _flag(self, node, what):
        self.findings.append(Finding(
            "PTA001", self.path, node.lineno,
            "%s on a hot path, outside any observe span" % what))


def _is_host_array(expr):
    """True for a receiver built by numpy (``np.asarray(x).tolist()``):
    a host array, whose methods read no device."""
    return (isinstance(expr, ast.Call)
            and (_dotted(expr.func) or "").split(".")[0] in ("np", "numpy"))


def _hot_roots(path):
    norm = path.replace(os.sep, "/")
    for suffix, names in HOT_PATHS.items():
        if norm.endswith(suffix):
            return names
    return None


def _check_hot_paths(tree, path, findings):
    hot = _hot_roots(path)
    if hot is None:
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in hot:
            _HotPathChecker(path, findings).run(node)


# -- PTA002: capture and export busters --------------------------------------

def _params(func_node):
    """A function's parameter names, ``self`` and ``cls`` left out: on
    the port the arguments of a captured or exported body are its
    tensors."""
    a = func_node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return {n for n in names if n not in ("self", "cls")}


def _tensor_in_test(test, params):
    """A tensor parameter used as a Python truth value in ``test`` (None
    checks, isinstance/len calls and attribute access are structure and
    exempt). Returns the offending name or None."""
    if isinstance(test, ast.Name):
        return test.id if test.id in params else None
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return None
        for operand in [test.left] + list(test.comparators):
            if isinstance(operand, ast.Name) and operand.id in params:
                return operand.id
        return None
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            hit = _tensor_in_test(v, params)
            if hit:
                return hit
        return None
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _tensor_in_test(test.operand, params)
    return None


class _CaptureBodies:
    """The bodies a file captures or exports, as (label, statements,
    tensor parameter names)."""

    def __init__(self, tree):
        self.tree = tree
        self.defs = {}      # name -> [FunctionDef] (any nesting)
        self.classes = {}   # name -> ClassDef
        self.parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node

    def _enclosing_def(self, node):
        cur = self.parents.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cur = self.parents.get(cur)
        return cur

    def _fn(self, fn):
        return ("function %r" % fn.name, fn.body, _params(fn))

    def collect(self):
        out, seen = [], set()

        def add(item, key):
            if key not in seen:
                seen.add(key)
                out.append(item)

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_capture(i.context_expr) for i in node.items):
                host = self._enclosing_def(node)
                params = _params(host) if host is not None else set()
                add(("the CUDA graph capture at line %d" % node.lineno,
                     node.body, params), ("with", node.lineno))
                # the step functions the capture calls, one level
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        for fn in self.defs.get(_call_name(sub.func), ()):
                            add(self._fn(fn), ("def", fn.lineno))
            elif isinstance(node, ast.Call) \
                    and (_dotted(node.func) or "").endswith("export.export") \
                    and node.args:
                for fn in self._exported(node.args[0], node):
                    add(self._fn(fn), ("def", fn.lineno))
        return out

    def _exported(self, arg, call):
        """The defs behind the first argument of torch.export.export: a
        def of this file, a wrapper module's ``forward`` (and the def it
        wraps), or a parameter of the enclosing helper resolved through
        the helper's call sites (``prog = factory(...)`` resolves to the
        factory's returned inner defs)."""
        if isinstance(arg, ast.Call):
            found = []
            cls = self.classes.get(_call_name(arg.func))
            if cls is not None:
                found += [n for n in cls.body
                          if isinstance(n, ast.FunctionDef)
                          and n.name == "forward"]
            for a in arg.args:
                found += self._exported(a, call)
            return found
        if not isinstance(arg, ast.Name):
            return []
        if arg.id in self.defs:
            return list(self.defs[arg.id])
        helper = self._enclosing_def(call)
        if helper is None or arg.id not in _params(helper):
            return []
        a = helper.args
        pos = [p.arg for p in a.posonlyargs + a.args].index(arg.id) \
            if arg.id in [p.arg for p in a.posonlyargs + a.args] else None
        found = []
        for site in ast.walk(self.tree):
            if not (isinstance(site, ast.Call)
                    and _call_name(site.func) == helper.name):
                continue
            if pos is None or pos >= len(site.args) \
                    or not isinstance(site.args[pos], ast.Name):
                continue
            found += self._resolve_value(site.args[pos].id, site)
        return found

    def _resolve_value(self, name, site):
        """Defs a name at ``site`` is bound to: a def of that name, or
        the inner defs returned by the factory call it was assigned."""
        if name in self.defs:
            return list(self.defs[name])
        scope = self._enclosing_def(site) or self.tree
        found = []
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in node.targets) \
                    and isinstance(node.value, ast.Call):
                for factory in self.defs.get(_call_name(node.value.func),
                                             ()):
                    inner = {n.name: n for n in ast.walk(factory)
                             if isinstance(n, ast.FunctionDef)
                             and n is not factory}
                    for ret in ast.walk(factory):
                        if isinstance(ret, ast.Return) \
                                and isinstance(ret.value, ast.Name) \
                                and ret.value.id in inner:
                            found.append(inner[ret.value.id])
        return found


def _check_capture_bodies(tree, path, findings):
    for label, body, params in _CaptureBodies(tree).collect():
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    hit = _tensor_in_test(node.test, params)
                    if hit:
                        findings.append(Finding(
                            "PTA002", path, node.lineno,
                            "Python branch on tensor argument %r inside "
                            "%s — a host sync that breaks the capture (or "
                            "a guard that re-exports per value)"
                            % (hit, label)))
                elif isinstance(node, ast.Call):
                    name = _call_name(node.func)
                    arg = None
                    if name in ("float", "int", "bool") and node.args \
                            and isinstance(node.args[0], ast.Name):
                        arg = node.args[0].id
                    elif name == "item" and isinstance(node.func,
                                                       ast.Attribute) \
                            and isinstance(node.func.value, ast.Name):
                        arg = node.func.value.id
                    if arg in params:
                        findings.append(Finding(
                            "PTA002", path, node.lineno,
                            "%s() on tensor argument %r inside %s forces "
                            "a host read" % (name, arg, label)))


def _check_op_names(tree, path, findings):
    """A non-constant name handed to torch.library.custom_op / define:
    a fresh op per call."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = _call_name(node.func)
        if name not in ("custom_op", "define"):
            continue
        owner = _dotted(node.func.value) if isinstance(
            node.func, ast.Attribute) else None
        if name == "define" and not (owner or "").endswith("library") \
                and not (owner or "").startswith("lib"):
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            continue
        what = ("an f-string" if isinstance(first, ast.JoinedStr)
                else "a non-constant name")
        findings.append(Finding(
            "PTA002", path, first.lineno,
            "%s in torch.library.%s — a fresh op per call defeats the "
            "exported programs' op lookup" % (what, name)))


# -- PTA003: unmanaged threads -----------------------------------------------

def _check_threads(tree, path, findings):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_name(node.func) != "Thread":
            continue
        kwargs = {kw.arg for kw in node.keywords}
        if "name" not in kwargs:
            findings.append(Finding(
                "PTA003", path, node.lineno,
                "threading.Thread(...) without name= — anonymous threads "
                "are invisible to the leak gate and postmortems"))


# -- PTA004: unlocked module registries --------------------------------------

def _module_imports_threading(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "threading":
                return True
    return False


def _module_registries(tree):
    """(container_names, lock_names) bound at module top level."""
    containers, locks = set(), set()
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = set()
        for t in node.targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
        if not names:
            continue
        value = node.value
        if isinstance(value, (ast.Dict, ast.List, ast.Set)):
            containers |= names
        elif isinstance(value, ast.Call):
            ctor = _call_name(value.func)
            if ctor in CONTAINER_CTORS:
                containers |= names
            elif ctor in LOCK_CTORS:
                locks |= names
    return containers, locks


class _RegistryChecker(ast.NodeVisitor):
    def __init__(self, path, containers, locks, findings):
        self.path = path
        self.containers = containers
        self.locks = locks
        self.findings = findings
        self.lock_depth = 0
        self.fn_depth = 0

    def visit_With(self, node):
        locked = any(_names_in(item.context_expr) & self.locks
                     for item in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    def _visit_fn(self, node):
        self.fn_depth += 1
        self.generic_visit(node)
        self.fn_depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _flag(self, node, name, how):
        if self.fn_depth == 0:
            return  # import-time mutation: single-threaded by definition
        if self.lock_depth > 0:
            return
        extra = (" (module locks: %s)" % ", ".join(sorted(self.locks))
                 if self.locks else " (module defines no lock)")
        self.findings.append(Finding(
            "PTA004", self.path, node.lineno,
            "module-level registry %r mutated via %s outside its lock%s"
            % (name, how, extra)))

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in MUTATORS \
                and isinstance(func.value, ast.Name) \
                and func.value.id in self.containers:
            self._flag(node, func.value.id, ".%s()" % func.attr)
        self.generic_visit(node)

    def _sub_target(self, target):
        if isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Name) \
                and target.value.id in self.containers:
            return target.value.id
        return None

    def visit_Assign(self, node):
        for t in node.targets:
            name = self._sub_target(t)
            if name:
                self._flag(node, name, "item assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        name = self._sub_target(node.target)
        if name:
            self._flag(node, name, "augmented item assignment")
        self.generic_visit(node)

    def visit_Delete(self, node):
        for t in node.targets:
            name = self._sub_target(t)
            if name:
                self._flag(node, name, "item deletion")
        self.generic_visit(node)


def _check_registries(tree, path, findings):
    if not _module_imports_threading(tree):
        return
    containers, locks = _module_registries(tree)
    if not containers:
        return
    _RegistryChecker(path, containers, locks, findings).visit(tree)


# -- PTA009: span hygiene & trace-context thread handoff ----------------------

# calls that produce a TraceContext (observe/tracing.py)
TRACE_CTX_ATTRS = {"mint", "from_traceparent", "child"}
TRACE_CTX_MODULES = {"tracing", "observe_tracing"}
# parameter names that ARE a trace context by convention
TRACE_NAME_HINTS = {"trace", "trace_ctx", "trace_context", "tracectx"}


def _is_trace_ctx_value(value):
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    if _call_name(func) in TRACE_CTX_ATTRS:
        return True
    return (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in TRACE_CTX_MODULES
            and func.attr in {"resolve", "sample"})


def _bound_names(fn):
    """Names bound inside a function body (params, assignments, for
    targets, with-as, comprehension targets)."""
    a = fn.args
    bound = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if getattr(a, "vararg", None):
        bound.add(a.vararg.arg)
    if getattr(a, "kwarg", None):
        bound.add(a.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                bound |= _names_in(t)
        elif isinstance(node, (ast.For, ast.comprehension)):
            bound |= _names_in(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            bound |= _names_in(node.optional_vars)
    return bound


def _free_reads(fn):
    """Names read inside ``fn`` that it does not bind itself."""
    reads = {n.id for n in ast.walk(fn)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    return reads - _bound_names(fn)


class _SpanHygieneChecker:
    """PTA009 both halves: a ``span(...)`` call that is a bare statement
    or an assignment is never entered; a ``threading.Thread(target=
    inner)`` whose inner function closure-captures a trace context hides
    a thread hop from the trace lane."""

    def __init__(self, path, findings):
        self.path = path
        self.findings = findings

    def check_spans(self, tree):
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node.func) == "span"
                    and (node.args or node.keywords)):
                continue
            parent = getattr(node, "_pl_parent", None)
            if isinstance(parent, ast.Expr):
                self.findings.append(Finding(
                    "PTA009", self.path, node.lineno,
                    "span(...) as a bare statement — the context "
                    "manager is never entered, so nothing is timed"))
            elif isinstance(parent, (ast.Assign, ast.AugAssign)):
                self.findings.append(Finding(
                    "PTA009", self.path, node.lineno,
                    "span(...) assigned instead of entered — use "
                    "`with ...span(...) as scope:`"))

    def check_thread_handoff(self, tree):
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            trace_names = {p for p in _bound_names(fn)
                           if p in TRACE_NAME_HINTS}
            local_defs = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.FunctionDef) and node is not fn:
                    local_defs.setdefault(node.name, node)
                elif isinstance(node, ast.Assign) \
                        and _is_trace_ctx_value(node.value):
                    for t in node.targets:
                        trace_names |= _names_in(t)
                elif isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Lambda) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    local_defs[node.targets[0].id] = node.value
            if not trace_names:
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and _call_name(node.func) == "Thread"):
                    continue
                target = next((kw.value for kw in node.keywords
                               if kw.arg == "target"), None)
                inner = None
                if isinstance(target, ast.Lambda):
                    inner = target
                elif isinstance(target, ast.Name):
                    inner = local_defs.get(target.id)
                if inner is None:
                    continue
                explicit = set()
                for kw in node.keywords:
                    if kw.arg in ("args", "kwargs"):
                        explicit |= _names_in(kw.value)
                captured = (_free_reads(inner) & trace_names) - explicit
                for name in sorted(captured):
                    self.findings.append(Finding(
                        "PTA009", self.path, node.lineno,
                        "trace context %r captured into a thread via "
                        "closure — pass it by value (Thread args= or a "
                        "queue item) so the hop stays explicit" % name))


def _check_span_hygiene(tree, path, findings):
    checker = _SpanHygieneChecker(path, findings)
    checker.check_spans(tree)
    checker.check_thread_handoff(tree)


# -- driver ------------------------------------------------------------------

def _annotate_parents(tree):
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._pl_parent = node


def _lint_file(source, path):
    """Per-file checks (PTA001-005, 007, 008, 009). Returns (kept
    findings, concurrency file model for the cross-file lock graph,
    suppressions)."""
    from paddle_tpu_torch.analyze import concurrency

    tree = ast.parse(source, filename=path)
    _annotate_parents(tree)
    findings = []
    _check_hot_paths(tree, path, findings)
    _check_capture_bodies(tree, path, findings)
    _check_op_names(tree, path, findings)
    _check_threads(tree, path, findings)
    _check_registries(tree, path, findings)
    _check_span_hygiene(tree, path, findings)
    model = concurrency.collect_file_model(tree, path)
    concurrency.check_file(tree, model, findings)
    suppressions = _suppressions(source)
    kept = [f for f in findings if not _suppressed(f, suppressions)]
    return kept, model, suppressions


def lint_source(source, path="<string>"):
    """Lint one source string; returns unsuppressed [Finding]. The
    PTA006 lock graph covers only this file here — multi-file cycles
    need :func:`lint_paths`/:func:`lint_tree`."""
    from paddle_tpu_torch.analyze import concurrency

    kept, model, suppressions = _lint_file(source, path)
    graph = []
    concurrency.check_lock_graph([model], graph)
    kept += [f for f in graph if not _suppressed(f, suppressions)]
    kept.sort(key=lambda f: (f.path, f.line, f.checker))
    return kept


def lint_paths(paths):
    """Lint several files, running the PTA006 lock-acquisition graph
    over all of them at once (cross-module cycles)."""
    from paddle_tpu_torch.analyze import concurrency

    findings = []
    models = []
    suppressions_of = {}
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            kept, model, suppressions = _lint_file(fh.read(), path)
        findings.extend(kept)
        models.append(model)
        suppressions_of[path] = suppressions
    graph = []
    concurrency.check_lock_graph(models, graph)
    findings += [f for f in graph
                 if not _suppressed(f, suppressions_of.get(f.path, {}))]
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


def tree_paths(root=None):
    """Every .py under ``root`` (default: the installed paddle_tpu_torch
    package), sorted; ``__pycache__`` and the kernels' ``build`` output
    left out."""
    if root is None:
        import paddle_tpu_torch

        root = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build")]
        paths.extend(os.path.join(dirpath, f)
                     for f in sorted(filenames) if f.endswith(".py"))
    return sorted(paths)


def lint_tree(root=None):
    """Lint every .py under ``root`` (default: the installed
    paddle_tpu_torch package). Returns (findings, files_checked)."""
    paths = tree_paths(root)
    return lint_paths(paths), len(paths)
