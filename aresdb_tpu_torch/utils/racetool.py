"""Race-detection tooling: lock-order analysis + schedule chaos.

Reference role: the reference leans on Go's `-race` ecosystem (its CI runs
`go test -race`; SURVEY §5 asks this rebuild for an equivalent). CPython's
GIL rules out torn reads, so the failure modes that matter here are the
LOGICAL races Go's detector also catches indirectly: lock-order inversions
(potential deadlocks) and invariant violations under adversarial thread
interleavings.

Two tools, composable:

- `instrument()` — wraps `threading.Lock`/`RLock` constructors so every
  acquisition records a lock-ORDER edge (locks already held -> lock being
  acquired) in a global graph. `check()` then detects cycles: a cycle
  A->B->A means two threads can acquire {A, B} in opposite orders — a
  potential deadlock even if the test run happened not to interleave that
  way. This is the deadlock half of `-race`, made deterministic: one
  single-threaded pass over each code path is enough to learn its order.

- `chaos()` — shrinks the interpreter's thread switch interval by ~5
  orders of magnitude and (optionally, via the instrumented locks) injects
  seeded micro-sleeps on acquisition, so a short storm test explores
  thousands of interleavings instead of the default scheduler's handful.
  This is the data-race half: races surface as invariant violations in
  the storm tests (tests/test_race_harness.py drives ingest / archive /
  backfill / snapshot / purge / query concurrently and asserts exact
  results).

Both are test-time only — nothing in the serving path imports this.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple


class LockGraph:
    """Lock-order graph: nodes are lock identities, edges 'held -> wanted'.

    Cycle detection reports potential deadlocks with the stack-less
    evidence Go's lockdep-style tools give: the two edges and the threads
    that created them.
    """

    def __init__(self):
        self._edges: Dict[int, Set[int]] = {}
        self._evidence: Dict[Tuple[int, int], str] = {}
        self._names: Dict[int, str] = {}
        self._mu = threading.Lock()

    def record(self, held: List[int], wanted: int, name: str = "") -> None:
        with self._mu:
            if name:
                self._names.setdefault(wanted, name)
            for h in held:
                if h == wanted:
                    continue
                self._edges.setdefault(h, set()).add(wanted)
                self._evidence.setdefault(
                    (h, wanted), threading.current_thread().name)

    def cycles(self) -> List[List[int]]:
        """All simple 2-cycles plus any longer cycle found by DFS."""
        with self._mu:
            edges = {k: set(v) for k, v in self._edges.items()}
        out = []
        seen = set()
        for a, succ in edges.items():
            for b in succ:
                if a in edges.get(b, ()) and (b, a) not in seen:
                    seen.add((a, b))
                    out.append([a, b])
        # longer cycles via iterative DFS with colors
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in edges}
        stack_path: List[int] = []

        def dfs(n):
            color[n] = GRAY
            stack_path.append(n)
            for m in edges.get(n, ()):
                if color.get(m, WHITE) == GRAY:
                    i = stack_path.index(m)
                    cyc = stack_path[i:]
                    if len(cyc) > 2:
                        out.append(list(cyc))
                elif color.get(m, WHITE) == WHITE and m in edges:
                    dfs(m)
            stack_path.pop()
            color[n] = BLACK

        for n in list(edges):
            if color[n] == WHITE:
                dfs(n)
        return out

    def describe(self, cycle: List[int]) -> str:
        def nm(n):
            return self._names.get(n, f"lock@{n:#x}")

        pairs = list(zip(cycle, cycle[1:] + cycle[:1]))
        lines = [f"potential deadlock: {' -> '.join(nm(n) for n in cycle)}"]
        for a, b in pairs:
            t = self._evidence.get((a, b), "?")
            lines.append(f"  {nm(a)} held while acquiring {nm(b)} "
                         f"(thread {t})")
        return "\n".join(lines)


_GRAPH = LockGraph()
_HELD = threading.local()
_CHAOS: Optional["_ChaosState"] = None


class _ChaosState:
    def __init__(self, seed: int, p_sleep: float, max_sleep: float):
        self.rng = random.Random(seed)
        self.p_sleep = p_sleep
        self.max_sleep = max_sleep
        self.mu = threading.Lock()

    def maybe_preempt(self):
        with self.mu:
            r = self.rng.random()
            d = self.rng.random() * self.max_sleep
        if r < self.p_sleep:
            time.sleep(d)


def _held_stack() -> List[int]:
    st = getattr(_HELD, "stack", None)
    if st is None:
        st = _HELD.stack = []
    return st


class InstrumentedLock:
    """Drop-in threading.Lock/RLock wrapper that records lock order and
    injects chaos preemption points."""

    def __init__(self, inner, name: str = ""):
        self._inner = inner
        self._name = name or f"{type(inner).__name__}@{id(inner):#x}"

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _GRAPH.record(_held_stack(), id(self._inner), self._name)
        if _CHAOS is not None:
            _CHAOS.maybe_preempt()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held_stack().append(id(self._inner))
        return ok

    def release(self):
        st = _held_stack()
        if id(self._inner) in st:
            # remove the most recent occurrence (RLocks re-enter)
            for i in range(len(st) - 1, -1, -1):
                if st[i] == id(self._inner):
                    del st[i]
                    break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    # Condition(lock) compatibility
    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()

    def _is_owned(self):
        try:
            return self._inner._is_owned()
        except AttributeError:
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True

    def _release_save(self):
        st = _held_stack()
        if id(self._inner) in st:
            st.remove(id(self._inner))
        try:
            return self._inner._release_save()
        except AttributeError:
            self._inner.release()
            return None

    def _acquire_restore(self, state):
        try:
            self._inner._acquire_restore(state)
        except AttributeError:
            self._inner.acquire()
        _held_stack().append(id(self._inner))


@contextmanager
def instrument():
    """Monkeypatch threading.Lock/RLock constructors so every lock created
    inside the context is order-tracked. Existing locks are untouched —
    build the system under test INSIDE the context."""
    real_lock, real_rlock = threading.Lock, threading.RLock
    counter = [0]

    def make(real, kind):
        def ctor():
            counter[0] += 1
            return InstrumentedLock(real(), f"{kind}#{counter[0]}")
        return ctor

    threading.Lock = make(real_lock, "Lock")
    threading.RLock = make(real_rlock, "RLock")
    try:
        yield _GRAPH
    finally:
        threading.Lock = real_lock
        threading.RLock = real_rlock


def check(graph: Optional[LockGraph] = None) -> None:
    """Raise AssertionError describing every lock-order cycle observed."""
    g = graph or _GRAPH
    cycles = g.cycles()
    if cycles:
        raise AssertionError(
            "\n".join(g.describe(c) for c in cycles))


def reset() -> None:
    global _GRAPH
    _GRAPH = LockGraph()


@contextmanager
def chaos(seed: int = 0, p_sleep: float = 0.05, max_sleep: float = 1e-4,
          switch_interval: float = 1e-5):
    """Adversarial scheduling: tiny switch interval + seeded micro-sleeps
    at instrumented-lock acquisition points."""
    global _CHAOS
    old = sys.getswitchinterval()
    sys.setswitchinterval(switch_interval)
    _CHAOS = _ChaosState(seed, p_sleep, max_sleep)
    try:
        yield
    finally:
        _CHAOS = None
        sys.setswitchinterval(old)
