"""Host-side session tier of continuous-batching serving
(paddle_tpu/serve/sessions.py): the port's own copy, host code only.

* :class:`SessionStore` — the bounded host-side page file: spilled
  recurrent carries (numpy, one row per leaf) plus decode position and
  metadata, keyed by session id. Eviction is priority-ordered LRU (``low``
  evicts before ``normal`` before ``high``, least recently used first
  within a class) with an SLO-aware override: a session touched within
  ``slo_grace_ms`` is passed over while any other candidate exists.
* :class:`SessionGone` — an evicted session's id is remembered in a
  bounded tombstone ring, and its next request fails fast (HTTP 410 Gone,
  serve/server.py) instead of restarting the conversation from a zero
  carry.

* :class:`ConsistentHashRing` — md5 over 160 virtual nodes per member:
  the replica fleets' session affinity (serve/fleet.py, serve/workers.py),
  the same preference order as the JAX package's ring for the same
  members.

Everything the store holds is host memory, committed by the scheduler's
``serve-session-spill`` writer thread after the device-to-host copy
landed: numpy rows, except that a bfloat16 leaf (a carry of a bundle
exported under the bfloat16 policy), which numpy cannot hold, stays a CPU
tensor (:func:`host_leaf`). A state exported from either package imports
into the other, through the frame codec (serve/workers.py) when the carry
is bfloat16.
"""

import collections
import hashlib
import threading
import time

# eviction order of the priority classes (the JAX package's serve/router.py
# PRIORITIES, strongest first): LOW pages out first
_PRIORITY_RANK = {"high": 0, "normal": 1, "low": 2}

# how many evicted session ids the tombstone ring remembers: enough to
# answer 410 for any plausible retry window, bounded so a million
# evictions cannot grow the host footprint the store exists to bound
_TOMBSTONE_CAP = 65536


class SessionGone(RuntimeError):
    """The session's carry was evicted from the session store — the
    conversation state is unrecoverable and the client must start a new
    session (HTTP 410 Gone on the serving front end, serve/server.py).
    Distinct from an *unknown* session id, which simply starts fresh:
    silently zero-restoring an evicted session would hand the user a
    model that forgot the conversation mid-sentence."""

    def __init__(self, message, session_id=None, reason=None):
        super().__init__(message)
        self.session_id = session_id
        self.reason = reason or "evicted"


def host_leaf(tensor):
    """A host copy of one carry leaf (a tensor on any device): a numpy
    array, or for bfloat16, which numpy has no dtype for, a CPU tensor of
    the same bits."""
    tensor = tensor.detach().cpu()
    if str(tensor.dtype) == "torch.bfloat16":
        return tensor.clone()
    return tensor.numpy().copy()


class SessionState:
    """One suspended session: the spilled carry rows (host arrays,
    :func:`host_leaf`, ``{recurrent_layer_name: [row, ...]}`` — the slot dimension sliced
    off), the absolute decode position, and the scheduling metadata the
    eviction policy orders by."""

    __slots__ = ("session_id", "carry", "pos", "priority", "last_used",
                 "nbytes")

    def __init__(self, session_id, carry, pos, priority="normal",
                 last_used=None):
        self.session_id = str(session_id)
        self.carry = carry
        self.pos = int(pos)
        self.priority = priority if priority in _PRIORITY_RANK else "normal"
        self.last_used = (time.monotonic() if last_used is None
                          else float(last_used))
        self.nbytes = sum(leaf.nbytes for leaves in carry.values()
                          for leaf in leaves)


class SessionStore:
    """Bounded host-side store of suspended sessions.

    ``capacity`` bounds the session count (the carries are fixed-size,
    so count × carry bytes IS the memory bound; ``stats()["bytes"]``
    reports the live total). ``put`` over capacity evicts by
    priority-ordered LRU with the ``slo_grace_ms`` override and returns
    the evicted states so the caller can account them (metrics +
    ``serve_swap`` steplog records + tombstones are the scheduler's
    job at its labels)."""

    def __init__(self, capacity=4096, slo_grace_ms=None, ttl_ms=None):
        if capacity < 1:
            raise ValueError("session store capacity must be >= 1, got %r"
                             % capacity)
        self.capacity = int(capacity)
        self.slo_grace_ms = (None if slo_grace_ms is None
                             else float(slo_grace_ms))
        self.ttl_ms = None if ttl_ms is None else float(ttl_ms)
        self._lock = threading.Lock()
        self._sessions = collections.OrderedDict()  # sid -> SessionState
        self._tombstones = collections.OrderedDict()  # sid -> reason
        # running byte total, maintained by put/pop/expire/tombstone:
        # the scheduler reads counts/bytes on every decode dispatch and
        # every swap, and an O(suspended) scan under this lock would
        # contend with the spill writer at exactly the million-session
        # scale the store exists for
        self._bytes = 0

    def __len__(self):
        with self._lock:
            return len(self._sessions)

    def __contains__(self, session_id):
        with self._lock:
            return str(session_id) in self._sessions

    def put(self, state):
        """Commit one suspended session; returns the list of
        :class:`SessionState` evicted to make room (empty when the
        store had space). Re-putting an id replaces its state."""
        sid = state.session_id
        evicted = []
        with self._lock:
            self._tombstones.pop(sid, None)  # resurrection clears a stone
            replaced = self._sessions.pop(sid, None)
            if replaced is not None:
                self._bytes -= replaced.nbytes
            self._sessions[sid] = state  # newest at the MRU end
            self._bytes += state.nbytes
            while len(self._sessions) > self.capacity:
                victim = self._pick_victim_locked(exclude=sid)
                self._sessions.pop(victim.session_id)
                self._bytes -= victim.nbytes
                self._tombstone_locked(victim.session_id, "capacity")
                evicted.append(victim)
        return evicted

    def pop(self, session_id):
        """Remove and return one suspended session's state. Raises
        :class:`SessionGone` for a tombstoned (evicted) id and
        :class:`KeyError` for an id the store never held."""
        sid = str(session_id)
        with self._lock:
            state = self._sessions.pop(sid, None)
            if state is not None:
                self._bytes -= state.nbytes
                return state
            reason = self._tombstones.get(sid)
        if reason is not None:
            raise SessionGone(
                "session %r was evicted from the session store "
                "(reason=%s); start a new session" % (sid, reason),
                session_id=sid, reason=reason)
        raise KeyError(sid)

    def tombstone(self, session_id, reason):
        """Mark an id gone (dropping any suspended state): its next
        request answers :class:`SessionGone` — the scheduler uses this
        when a failed decode dispatch poisons resident carries."""
        with self._lock:
            dropped = self._sessions.pop(str(session_id), None)
            if dropped is not None:
                self._bytes -= dropped.nbytes
            self._tombstone_locked(str(session_id), reason)

    def gone_reason(self, session_id):
        """The eviction reason of a tombstoned id, else None — the fast
        admission-time 410 check (no exception on the accept path)."""
        with self._lock:
            return self._tombstones.get(str(session_id))

    def expire(self, now=None):
        """Evict sessions idle past ``ttl_ms`` (no-op without a TTL);
        returns the expired states for the caller's accounting."""
        if self.ttl_ms is None:
            return []
        now = time.monotonic() if now is None else now
        horizon = now - self.ttl_ms / 1e3
        expired = []
        with self._lock:
            for sid in [s for s, st in self._sessions.items()
                        if st.last_used < horizon]:
                state = self._sessions.pop(sid)
                self._bytes -= state.nbytes
                expired.append(state)
                self._tombstone_locked(sid, "ttl")
        return expired

    def _tombstone_locked(self, sid, reason):
        self._tombstones.pop(sid, None)
        self._tombstones[sid] = reason
        while len(self._tombstones) > _TOMBSTONE_CAP:
            self._tombstones.popitem(last=False)

    def _pick_victim_locked(self, exclude=None):
        """Priority-ordered LRU with the SLO grace override. The
        OrderedDict iterates insertion (= LRU) order, so the first
        candidate at the weakest priority rank is the victim; sessions
        inside their SLO grace window are passed over while any
        non-grace candidate exists (capacity is a hard bound: when
        EVERY candidate is in grace, plain priority-LRU applies)."""
        grace_after = None
        if self.slo_grace_ms is not None:
            grace_after = time.monotonic() - self.slo_grace_ms / 1e3
        best = best_graced = None

        def rank(state):
            return (-_PRIORITY_RANK[state.priority], state.last_used)

        for state in self._sessions.values():
            if state.session_id == exclude:
                continue
            graced = (grace_after is not None
                      and state.last_used >= grace_after)
            if graced:
                if best_graced is None or rank(state) < rank(best_graced):
                    best_graced = state
            elif best is None or rank(state) < rank(best):
                best = state
        victim = best if best is not None else best_graced
        if victim is None:
            raise RuntimeError(
                "session store over capacity with no evictable session")
        return victim

    def touch(self, session_id):
        """Refresh a suspended session's LRU position (a request
        arrived for it); silently ignores unknown ids."""
        with self._lock:
            state = self._sessions.get(str(session_id))
            if state is not None:
                state.last_used = time.monotonic()
                self._sessions.move_to_end(str(session_id))

    def suspended_count(self):
        """O(1) suspended-session count — what the scheduler stamps on
        every decode dispatch and gauge update."""
        with self._lock:
            return len(self._sessions)

    def stats(self):
        with self._lock:
            return {
                "suspended": len(self._sessions),
                "capacity": self.capacity,
                "bytes": self._bytes,
                "tombstones": len(self._tombstones),
            }


class ConsistentHashRing:
    """Consistent hashing over replica indices for fleet-wide session
    affinity (paddle_tpu/serve/sessions.py): ``order(session_id)`` returns
    every member in ring-walk preference order, so a fleet routes a
    session to the first *eligible* entry — the same replica every time
    while it lives (its store holds the carry), and a stable fallback when
    it dies (only the dead member's sessions move; 160 virtual nodes per
    member smooth the arcs)."""

    def __init__(self, members, vnodes=160):
        members = list(members)
        if not members:
            raise ValueError("hash ring needs at least one member")
        points = []
        for member in members:
            for v in range(vnodes):
                digest = hashlib.md5(
                    ("%s:%d" % (member, v)).encode()).digest()
                points.append((int.from_bytes(digest[:8], "big"), member))
        points.sort()
        self._points = points
        self._members = members

    @staticmethod
    def _hash(session_id):
        digest = hashlib.md5(str(session_id).encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def order(self, session_id):
        """Every member once, in preference order for one session id (the
        first is the session's home)."""
        h = self._hash(session_id)
        points = self._points
        lo, hi = 0, len(points)
        while lo < hi:
            mid = (lo + hi) // 2
            if points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        seen, out = set(), []
        for i in range(len(points)):
            member = points[(lo + i) % len(points)][1]
            if member not in seen:
                seen.add(member)
                out.append(member)
                if len(out) == len(self._members):
                    break
        return out

    def lookup(self, session_id):
        """The session's home member (first in :meth:`order`)."""
        return self.order(session_id)[0]
