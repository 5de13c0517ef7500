"""Interprocedural concurrency and graph-replay analysis
(paddle_tpu/analyze/concurrency.py, PTA008 read in PyTorch terms).

The statement-level checkers (lint.py) look at one call or one
assignment. These look across methods, files and replays, and run over
the full tree as part of ``cli analyze --all``:

* **PTA005 unguarded-shared-state** — per class, infer which ``self._*``
  attributes are guarded by which instance lock/Condition: an attribute
  *mutated* inside ``with self.<lock>:`` (in any method outside
  ``__init__``) is lock-protected, and every access of it — read or
  write — from another method must hold one of its guarding locks.
  One-level helper resolution: a private method whose every in-class
  call site holds a class lock is analyzed as guarded. Nested function
  bodies (thread targets, callbacks) are analyzed as UNGUARDED even when
  defined inside a lock block — they run later, on whatever thread calls
  them.
* **PTA006 lock-order-inversion** — the cross-module lock acquisition
  graph: nodes are instance locks (``Class.lock_attr``), edges mean
  "acquired while held". Direct nesting (``with a, b:`` acquires left to
  right) gives exact edges; calls made while holding a lock resolve by
  method NAME across every scanned class, common container/primitive
  method names excluded. A cycle is a potential deadlock.
* **PTA007 naked-condition-wait** — ``Condition.wait()`` outside a
  ``while`` loop; only receivers statically known to be Conditions.
* **PTA008 use-after-donate** — PyTorch donates nothing; the port's
  hazard of the same class is a captured CUDA graph's static tensors
  read after a later ``replay()`` has overwritten them. A graph's static
  tensors are the names bound inside its ``with torch.cuda.graph(g):``
  block and the ``STATIC_KEYS`` entries of the dict that holds it
  (``entry["out"]`` beside ``entry["graph"]``, trainer.py). A name bound
  to them without a copy (``torch.clone``) is an alias, valid until the
  graph's next replay. Flagged: (a) an alias read after a later replay
  of its graph with no rebind in between; (b) inside a loop that
  replays, an alias bound after the replay and read before its binding
  (so in the next iteration, after the next replay), or the static
  tensors collected into a container; (c) the static tensors returned,
  uncopied, from a function that replays their graph — the caller holds
  them past the next replay (the reason ``SGD._replay`` clones).

Suppression uses the same line-scoped ``# paddle-lint: disable=ID``
comments as PTA001-004 (applied by the lint driver).
"""

import ast

# lint.py imports this module only inside function bodies, so the
# top-level import of its shared AST helper cannot cycle
from paddle_tpu_torch.analyze.lint import (_call_name, _dotted,
                                           _is_graph_capture)

LOCK_CTORS = {"Lock", "RLock", "Condition"}
MUTATORS = {"add", "append", "appendleft", "extend", "insert", "remove",
            "discard", "pop", "popleft", "clear", "update", "setdefault"}

# Methods whose accesses are construction-time (single-threaded by
# definition) and never flagged by PTA005.
CONSTRUCTION_METHODS = {"__init__", "__del__", "__new__"}

# Method names NEVER used for cross-class call-edge resolution in the
# lock graph: they collide with builtin container/instrument methods on
# practically every lock-held line (self._queue.append, dict.get,
# gauge.set, counter.inc ...) and would wire every lock to every other.
UNRESOLVED_CALL_NAMES = {
    "get", "set", "add", "pop", "update", "setdefault", "append",
    "appendleft", "popleft", "remove", "discard", "clear", "extend",
    "insert", "items", "keys", "values", "inc", "dec", "observe",
    "reset", "state", "value", "copy", "join", "put", "split",
    "format", "write", "read", "close", "open",
}

# Keys of the dict that holds a captured graph under which its static
# tensors are kept (trainer.py: entry["graph"], entry["out"],
# entry["feeds"]), and the attribute prefix of a graph's static tensors
# held on an object (``self.static_out``).
STATIC_KEYS = {"out", "outs", "feeds", "static_in", "static_out"}
STATIC_ATTR_PREFIX = "static_"

# Calls whose result no longer aliases a tensor's memory.
COPY_CALLS = {"clone", "copy", "deepcopy", "cpu", "numpy", "tolist", "item"}

# Container calls that keep a reference to their argument.
COLLECTORS = {"append", "appendleft", "extend", "insert", "add", "put",
              "put_nowait", "setdefault", "update"}


def _finding(checker, path, line, message):
    from paddle_tpu_torch.analyze.lint import Finding

    return Finding(checker, path, line, message)


# -- per-class scan ----------------------------------------------------------

class _Access:
    __slots__ = ("attr", "mutate", "locks", "line")

    def __init__(self, attr, mutate, locks, line):
        self.attr = attr
        self.mutate = mutate
        self.locks = locks  # frozenset of class lock attrs held
        self.line = line


class _MethodScan(ast.NodeVisitor):
    """One pass over a method body tracking which class locks are held.

    Collects attribute accesses (for PTA005), lock acquisitions and
    lock-held calls (for PTA006), and condition waits (for PTA007).
    Nested function/lambda bodies are scanned with an EMPTY lock stack:
    a closure defined under a lock runs later, unguarded.
    """

    def __init__(self, cls):
        self.cls = cls
        self.held = []           # stack of frozensets of lock attrs
        self.accesses = []       # [_Access]
        self.acquisitions = []   # (lock_attr, held_before frozenset, line)
        self.calls = []          # (name, is_self_call, held frozenset, line)
        self.waits = []          # (cond_attr, in_while, line)
        self.unlocked_self_calls = set()  # self.m() with no lock held
        self._while_depth = 0

    def _now_held(self):
        out = set()
        for layer in self.held:
            out |= layer
        return frozenset(out)

    def _self_attr(self, node):
        """X for a ``self.X`` Attribute node, else None."""
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        return None

    # -- locks ---------------------------------------------------------------
    def visit_With(self, node):
        # items acquire LEFT TO RIGHT (`with a, b:` == nested withs), so
        # each item's acquisition records the earlier items as held —
        # an AB/BA inversion written multi-item style is still a cycle
        pushed = 0
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            self.visit(item.context_expr)
            if attr in self.cls.lock_attrs:
                self.acquisitions.append((attr, self._now_held(),
                                          node.lineno))
                self.held.append(frozenset({attr}))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    visit_AsyncWith = visit_With

    def _visit_nested(self, node):
        # thread targets / callbacks: defined here, run later, unguarded
        saved, self.held = self.held, []
        saved_while, self._while_depth = self._while_depth, 0
        self.generic_visit(node)
        self.held = saved
        self._while_depth = saved_while

    visit_FunctionDef = _visit_nested
    visit_AsyncFunctionDef = _visit_nested
    visit_Lambda = _visit_nested

    def visit_While(self, node):
        self._while_depth += 1
        self.generic_visit(node)
        self._while_depth -= 1

    # -- accesses ------------------------------------------------------------
    def _record(self, attr, mutate, line):
        if attr is None or attr in self.cls.lock_attrs:
            return
        self.accesses.append(_Access(attr, mutate, self._now_held(), line))

    def visit_Assign(self, node):
        for t in node.targets:
            self._record_target(t, node.lineno)
        self.visit(node.value)

    def _record_target(self, target, line):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, line)
        elif isinstance(target, ast.Starred):
            self._record_target(target.value, line)
        else:
            attr = self._self_attr(target)
            if attr is not None:
                self._record(attr, True, line)
            elif isinstance(target, ast.Subscript):
                self._record(self._self_attr(target.value), True, line)
                self.visit(target)

    def visit_AnnAssign(self, node):
        if node.value is not None:  # bare annotations bind nothing
            self._record_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_AugAssign(self, node):
        attr = self._self_attr(node.target)
        if attr is None and isinstance(node.target, ast.Subscript):
            attr = self._self_attr(node.target.value)
        self._record(attr, True, node.lineno)
        self.visit(node.value)

    def visit_Delete(self, node):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._record(self._self_attr(t.value), True, t.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        func = node.func
        name = _call_name(func)
        recv_attr = None
        if isinstance(func, ast.Attribute):
            recv_attr = self._self_attr(func.value)
        # condition waits (PTA007)
        if name == "wait" and recv_attr in self.cls.cond_attrs:
            self.waits.append((recv_attr, self._while_depth > 0,
                               node.lineno))
        # mutator calls on self attributes (self._queue.append(...))
        if name in MUTATORS and recv_attr is not None:
            self._record(recv_attr, True, node.lineno)
        # calls made while holding a lock (PTA006 edges) + self-call
        # sites for the guarded-helper resolution
        held = self._now_held()
        is_self_call = self._self_attr(func) is not None
        if held and name is not None:
            self.calls.append((name, is_self_call, held, node.lineno))
        elif is_self_call and name is not None:
            self.unlocked_self_calls.add(name)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if isinstance(node.ctx, ast.Load):
            self._record(self._self_attr(node), False, node.lineno)
        self.generic_visit(node)


class _ClassModel:
    """Lock/access model of one class (PTA005/006/007 input)."""

    def __init__(self, node, path):
        self.name = node.name
        self.path = path
        self.lock_attrs = set()
        self.cond_attrs = set()
        self.rlock_attrs = set()
        methods = [n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for m in methods:
            for sub in ast.walk(m):
                if isinstance(sub, ast.Assign) \
                        and isinstance(sub.value, ast.Call):
                    ctor = _call_name(sub.value.func)
                    if ctor in LOCK_CTORS:
                        for t in sub.targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                self.lock_attrs.add(t.attr)
                                if ctor == "Condition":
                                    self.cond_attrs.add(t.attr)
                                elif ctor == "RLock":
                                    self.rlock_attrs.add(t.attr)
        self.scans = {}
        if self.lock_attrs:
            for m in methods:
                scan = _MethodScan(self)
                for stmt in m.body:
                    scan.visit(stmt)
                self.scans[m.name] = scan


def _collect_classes(tree, path):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            model = _ClassModel(node, path)
            if model.lock_attrs:
                out.append(model)
    return out


# -- PTA005 ------------------------------------------------------------------

def check_unguarded_state(classes, findings):
    for cls in classes:
        contexts = _call_contexts(cls)

        def effective(mname, scan):
            """(attr, mutate, effective lock set, line, via) triples —
            a private helper's accesses are replicated once per in-class
            call context (one-level helper resolution): called under the
            lock, they are guarded; called without it, they are not."""
            ctxs = contexts.get(mname) or {frozenset()}
            for acc in scan.accesses:
                for ctx in ctxs:
                    yield acc.attr, acc.mutate, acc.locks | ctx, acc.line

        # which locks guard which attrs: a mutation under a lock outside
        # construction marks the attr as protected by those locks
        protected = {}
        for mname, scan in cls.scans.items():
            if mname in CONSTRUCTION_METHODS:
                continue
            for attr, mutate, locks, _line in effective(mname, scan):
                if mutate and locks:
                    protected.setdefault(attr, set()).update(locks)
        if not protected:
            continue
        for mname, scan in cls.scans.items():
            if mname in CONSTRUCTION_METHODS:
                continue
            seen = set()
            for attr, mutate, locks, line in effective(mname, scan):
                guards = protected.get(attr)
                if not guards or (locks & guards):
                    continue
                key = (attr, line)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(_finding(
                    "PTA005", cls.path, line,
                    "attribute 'self.%s' is guarded by %s elsewhere in "
                    "%s but %s here without it (method %s)"
                    % (attr,
                       "/".join("self.%s" % g for g in sorted(guards)),
                       cls.name,
                       "written" if mutate else "read", mname)))


def _call_contexts(cls):
    """{private method name: set of lock-context frozensets} from its
    in-class call sites. Construction-method call sites are skipped —
    __init__ running a helper unlocked is single-threaded, not a leak.
    Methods without recorded in-class call sites (public surface) get
    the empty context."""
    out = {}
    for caller, scan in cls.scans.items():
        if caller in CONSTRUCTION_METHODS:
            continue
        for name, is_self, held, _line in scan.calls:
            if is_self and name in cls.scans and name.startswith("_"):
                out.setdefault(name, set()).add(held)
        for name in scan.unlocked_self_calls:
            if name in cls.scans and name.startswith("_"):
                out.setdefault(name, set()).add(frozenset())
    return out


# -- PTA006 ------------------------------------------------------------------

def check_lock_graph(file_models, findings):
    """Cross-module lock acquisition graph; cycles are PTA006.

    ``file_models`` is ``[(path, classes)]`` as built by
    :func:`collect_file_model`.
    """
    classes = [c for _path, cls_list in file_models for c in cls_list]
    # locks acquired directly inside each method, by (class, method)
    direct = {}
    by_method_name = {}
    for cls in classes:
        for mname, scan in cls.scans.items():
            locks = sorted({lock for lock, _held, _l in scan.acquisitions})
            direct[(cls.name, mname)] = locks
            if locks:
                by_method_name.setdefault(mname, []).append((cls, locks))

    edges = {}  # node -> {node: (path, line, why)}

    def node_id(cls, lock):
        return "%s.%s" % (cls.name, lock)

    def add_edge(a, b, path, line, why):
        tgt = edges.setdefault(a, {})
        if b not in tgt:
            tgt[b] = (path, line, why)

    for cls in classes:
        for mname, scan in cls.scans.items():
            # direct nesting: acquire B while holding A (re-entering an
            # RLock is legal, not a self-deadlock)
            for lock, held, line in scan.acquisitions:
                for h in held:
                    if h == lock and lock in cls.rlock_attrs:
                        continue
                    add_edge(node_id(cls, h), node_id(cls, lock),
                             cls.path, line, "nested with in %s()" % mname)
            # calls while holding a lock
            for name, is_self, held, line in scan.calls:
                targets = []
                if is_self and name in cls.scans:
                    targets = [(cls, direct[(cls.name, name)])]
                elif not is_self and name not in UNRESOLVED_CALL_NAMES:
                    targets = by_method_name.get(name, [])
                for target_cls, locks in targets:
                    for lock in locks:
                        for h in held:
                            add_edge(node_id(cls, h),
                                     node_id(target_cls, lock),
                                     cls.path, line,
                                     "%s.%s() called from %s.%s()"
                                     % (target_cls.name, name,
                                        cls.name, mname))

    for cycle in _cycles(edges):
        chain = " -> ".join(cycle + [cycle[0]])
        path, line, why = edges[cycle[0]][cycle[1] if len(cycle) > 1
                                          else cycle[0]]
        findings.append(_finding(
            "PTA006", path, line,
            "lock acquisition cycle %s (%s): two threads taking these "
            "locks in opposite orders deadlock" % (chain, why)))


def _cycles(edges):
    """Elementary cycles of a small digraph, one representative per
    cycle set (rotation-normalized). DFS with a visited-stack."""
    seen_cycles = set()
    out = []

    def dfs(start, node, stack, on_stack):
        for nxt in sorted(edges.get(node, {})):
            if nxt == start:
                cycle = tuple(stack)
                # normalize rotation so each cycle reports once
                i = cycle.index(min(cycle))
                norm = cycle[i:] + cycle[:i]
                if norm not in seen_cycles:
                    seen_cycles.add(norm)
                    out.append(list(norm))
            elif nxt not in on_stack and nxt > start:
                # only explore nodes ordered after start: each cycle is
                # found from its smallest node exactly once
                stack.append(nxt)
                on_stack.add(nxt)
                dfs(start, nxt, stack, on_stack)
                on_stack.discard(nxt)
                stack.pop()

    for start in sorted(edges):
        dfs(start, start, [start], {start})
    return out


# -- PTA007 ------------------------------------------------------------------

def check_naked_waits(tree, classes, path, findings):
    # class-scoped: self.<cond>.wait() outside a while
    for cls in classes:
        for mname, scan in cls.scans.items():
            for cond, in_while, line in scan.waits:
                if not in_while:
                    findings.append(_finding(
                        "PTA007", path, line,
                        "Condition 'self.%s'.wait() outside a while "
                        "loop in %s.%s(): a woken waiter must re-test "
                        "its predicate (spurious/stolen wakeups)"
                        % (cond, cls.name, mname)))
    # module/function-local conditions: name = threading.Condition()
    local_conds = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _call_name(node.value.func) == "Condition":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local_conds.add(t.id)
    if not local_conds:
        return
    _flag_local_waits(tree, local_conds, path, findings)


def _flag_local_waits(tree, conds, path, findings):
    class V(ast.NodeVisitor):
        def __init__(self):
            self.while_depth = 0

        def visit_While(self, node):
            self.while_depth += 1
            self.generic_visit(node)
            self.while_depth -= 1

        def visit_Call(self, node):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "wait" \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in conds and self.while_depth == 0:
                findings.append(_finding(
                    "PTA007", path, node.lineno,
                    "Condition %r.wait() outside a while loop: a woken "
                    "waiter must re-test its predicate"
                    % func.value.id))
            self.generic_visit(node)

    V().visit(tree)


# -- PTA008 ------------------------------------------------------------------

def _graph_key(expr):
    """The name a graph is held under: ``entry`` for ``entry["graph"]``,
    the dotted name otherwise (``g``, ``self._graph``)."""
    if isinstance(expr, ast.Subscript):
        return _dotted(expr.value)
    return _dotted(expr)


def _is_copy(expr):
    """True when ``expr`` copies what it reads: a COPY_CALLS call in it,
    or ``clone`` handed on as a function (``tree_map(torch.clone, x)``)."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and _call_name(sub.func) in COPY_CALLS:
            return True
        if isinstance(sub, (ast.Name, ast.Attribute)) \
                and _call_name(sub) == "clone":
            return True
    return False


def _keys_match(source_key, replay_key):
    if source_key is None or replay_key is None:
        return True
    return (source_key == replay_key
            or replay_key.startswith(source_key + ".")
            or source_key.startswith(replay_key + "."))


class _GraphModel:
    """One function's replays, capture-bound names and static aliases."""

    def __init__(self, func, parents):
        self.func = func
        self.parents = parents
        self.replays = []   # (line, key, node)
        self.captured = {}  # name bound inside a capture block -> key
        self.aliases = []   # (name, bind line, key)
        for node in ast.walk(func):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if _is_graph_capture(expr) and expr.args:
                        key = _graph_key(expr.args[0])
                        for stmt in node.body:
                            for sub in ast.walk(stmt):
                                if isinstance(sub, ast.Name) \
                                        and isinstance(sub.ctx, ast.Store):
                                    self.captured[sub.id] = key
            elif isinstance(node, ast.Call) \
                    and _call_name(node.func) == "replay" \
                    and isinstance(node.func, ast.Attribute) \
                    and not node.args:
                self.replays.append((node.lineno,
                                     _graph_key(node.func.value), node))
        # two passes: an alias of an alias (``first = out``) resolves
        for _ in range(2):
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) \
                        and not _is_copy(node.value):
                    for key in self.sources(node.value, aliases=True):
                        for t in node.targets:
                            for sub in ast.walk(t):
                                if isinstance(sub, ast.Name) \
                                        and sub.id not in self.captured:
                                    alias = (sub.id, node.lineno, key)
                                    if alias not in self.aliases:
                                        self.aliases.append(alias)

    def sources(self, expr, aliases=False):
        """Graph keys of the static tensors ``expr`` reads (uncopied);
        with ``aliases``, of the aliases it reads too."""
        known = {}
        if aliases:
            for name, _line, key in self.aliases:
                known.setdefault(name, key)
        keys = []
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in known:
                keys.append(known[sub.id])
                continue
            if isinstance(sub, ast.Subscript) \
                    and isinstance(sub.slice, ast.Constant) \
                    and sub.slice.value in STATIC_KEYS:
                keys.append(_dotted(sub.value))
            elif isinstance(sub, ast.Attribute) \
                    and sub.attr.startswith(STATIC_ATTR_PREFIX):
                keys.append(_dotted(sub.value))
            elif isinstance(sub, ast.Name) \
                    and isinstance(sub.ctx, ast.Load) \
                    and sub.id in self.captured:
                keys.append(self.captured[sub.id])
        return keys

    def loop_of(self, node):
        cur = self.parents.get(node)
        while cur is not None and cur is not self.func:
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                return cur
            cur = self.parents.get(cur)
        return None


def check_use_after_replay(tree, path, findings):
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        model = _GraphModel(func, parents)
        if not model.replays:
            continue
        _flag_alias_reads(model, path, findings)
        _flag_loop_and_return(model, path, findings)


def _flag_alias_reads(model, path, findings):
    flagged = set()
    for name, bind, key in model.aliases:
        binds = _bind_lines(model.func, name)
        reads = _read_lines(model.func, name)
        for line, rkey, rnode in model.replays:
            if not _keys_match(key, rkey):
                continue
            # (a) bound before the replay, read after it, no rebind
            if line > bind:
                for r in reads:
                    if r <= line or any(line <= b <= r for b in binds):
                        continue
                    if (name, r) not in flagged:
                        flagged.add((name, r))
                        findings.append(_finding(
                            "PTA008", path, r,
                            "%r aliases the static tensors of graph %s and "
                            "is read after its replay at line %d "
                            "overwrote them" % (name, rkey or "?", line)))
                    break
            # (b) in a loop: bound after the replay, read before the
            # binding, i.e. in the next iteration after the next replay
            loop = model.loop_of(rnode)
            if loop is None or not (loop.lineno <= bind <= _max_line(loop)) \
                    or bind <= line:
                continue
            for r in reads:
                if line < r < bind and not any(line <= b < r for b in binds) \
                        and (name, r) not in flagged:
                    flagged.add((name, r))
                    findings.append(_finding(
                        "PTA008", path, r,
                        "%r aliases the static tensors of graph %s bound at "
                        "line %d and is read in the next iteration, after "
                        "the replay at line %d overwrote them"
                        % (name, rkey or "?", bind, line)))
                    break


def _flag_loop_and_return(model, path, findings):
    for node in ast.walk(model.func):
        if isinstance(node, ast.Call) \
                and _call_name(node.func) in COLLECTORS and node.args:
            loop = model.loop_of(node)
            if loop is None:
                continue
            for arg in node.args:
                if _is_copy(arg):
                    continue
                for key in model.sources(arg):
                    hits = [line for line, rkey, rnode in model.replays
                            if _keys_match(key, rkey)
                            and model.loop_of(rnode) is loop]
                    if hits:
                        findings.append(_finding(
                            "PTA008", path, node.lineno,
                            "the static tensors of graph %s are collected "
                            "inside a loop that replays it (line %d): every "
                            "entry holds the last replay's values"
                            % (key or "?", hits[0])))
                        break
        elif isinstance(node, ast.Return) and node.value is not None \
                and not _is_copy(node.value):
            for key in model.sources(node.value):
                hits = [line for line, rkey, _n in model.replays
                        if _keys_match(key, rkey)]
                if hits:
                    findings.append(_finding(
                        "PTA008", path, node.lineno,
                        "the static tensors of graph %s are returned "
                        "uncopied from %s(), which replays it (line %d): "
                        "the caller holds them past the next replay"
                        % (key or "?", model.func.name, hits[0])))
                    break


def _bind_lines(func_node, name):
    """Source lines where ``name`` is (re)bound inside ``func_node``."""
    lines = []
    for node in ast.walk(func_node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if _dotted(sub) == name and isinstance(
                        getattr(sub, "ctx", ast.Store()), ast.Store):
                    lines.append(node.lineno)
    return sorted(lines)


def _max_line(node):
    return max((getattr(n, "lineno", 0) for n in ast.walk(node)),
               default=getattr(node, "lineno", 0))


def _read_lines(func_node, name):
    """Sorted lines where ``name`` is read (Load) inside ``func_node``."""
    lines = set()
    for node in ast.walk(func_node):
        if isinstance(node, (ast.Name, ast.Attribute)) \
                and isinstance(getattr(node, "ctx", None), ast.Load) \
                and _dotted(node) == name:
            lines.add(node.lineno)
    return sorted(lines)


# -- driver ------------------------------------------------------------------

def collect_file_model(tree, path):
    """(path, class models) — the unit the per-file checks and the
    cross-module lock graph both consume."""
    return (path, _collect_classes(tree, path))


def check_file(tree, file_model, findings):
    """PTA005 + PTA007 + PTA008 over one parsed file."""
    path, classes = file_model
    check_unguarded_state(classes, findings)
    check_naked_waits(tree, classes, path, findings)
    check_use_after_replay(tree, path, findings)
