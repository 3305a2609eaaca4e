"""Runtime lock tracing and deterministic interleavings for the host
planes (the runtime half of ``openembedding_tpu/analysis/concurrency.py``).

The port's threaded host code (checkpoint writer pools, the serving
registry, the compactor) takes its locks through :func:`make_lock` and
marks its interleaving points with :func:`sync_point`, as the JAX
package does:

* **traced locks**: with ``OE_REPORT_TRACE_LOCKS=1`` (or
  :func:`set_trace_locks`) at construction, :func:`make_lock` returns a
  :class:`TracedLock` that records a lock-order graph, reports every
  cycle as a potential deadlock (:func:`potential_deadlocks`) and keeps
  acquire/contention/wait/hold counters (:func:`lock_stats`); otherwise
  a plain ``threading.Lock``, so production paths pay nothing per
  acquire;
* **schedules**: :func:`sync_point` is a no-op unless a schedule is
  installed (:func:`install_schedule`): :class:`SerialSchedule` replays a
  prescribed order of points across threads, :class:`PointGate` parks
  threads at named points until a test opens them, and
  ``analysis/chaos.py``'s ``FaultPlan`` injects faults there.

The AST lock-discipline analyzer of the JAX module has no counterpart
here; it lints the JAX package's source.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple


def _reaches_in(succ, src, dst) -> bool:
    """dst reachable from src in the successor mapping ``succ``."""
    seen, work = set(), [src]
    while work:
        n = work.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        work.extend(succ.get(n, ()))
    return False


# ---------------------------------------------------------------------------
# traced locks, lock-order graph, contention counters
# ---------------------------------------------------------------------------

_TRACE_ENV = "OE_REPORT_TRACE_LOCKS"
_trace_forced: Optional[bool] = None

_RT = threading.Lock()                   # guards the registries below
_ORDER: Dict[str, Set[str]] = {}         # lock name -> successors
_CYCLES: List[str] = []                  # recorded potential deadlocks
_CYCLE_PAIRS: Set[Tuple[str, str]] = set()
_STATS: Dict[str, Dict[str, float]] = {}
_HELD = threading.local()                # .stack: [(name, t_acquired)]
_STACKS: List[list] = []                 # every thread's held stack, for
                                         # cross-thread releases


def set_trace_locks(on: Optional[bool]) -> None:
    """Force runtime lock tracing on/off; ``None`` restores the
    environment-variable default (``OE_REPORT_TRACE_LOCKS``)."""
    global _trace_forced
    _trace_forced = on


def trace_locks_enabled() -> bool:
    if _trace_forced is not None:
        return _trace_forced
    v = os.environ.get(_TRACE_ENV, "")
    return v.lower() in ("1", "true", "yes", "on")


def make_lock(name: str):
    """A named lock: :class:`TracedLock` when tracing is enabled, a plain
    ``threading.Lock`` otherwise (decided once, at construction)."""
    return TracedLock(name) if trace_locks_enabled() else threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    return TracedRLock(name) if trace_locks_enabled() \
        else threading.RLock()


def reset_runtime() -> None:
    """Clear the lock-order graph, recorded cycles and counters (test
    isolation). Live threads' held stacks stay registered."""
    with _RT:
        _ORDER.clear()
        _CYCLES.clear()
        _CYCLE_PAIRS.clear()
        _STATS.clear()


def potential_deadlocks() -> List[str]:
    """Every lock-order cycle the traced locks have observed so far: an
    A -> B order recorded anywhere plus a B -> A acquisition is reported
    even if the schedule never realized the deadlock."""
    with _RT:
        return list(_CYCLES)


def lock_stats() -> Dict[str, Dict[str, float]]:
    """Per-lock runtime counters: ``acquires``, ``contended`` (the acquire
    found the lock held), ``wait_s`` (time blocked acquiring), ``hold_s``
    (time held)."""
    with _RT:
        return {k: dict(v) for k, v in _STATS.items()}


def _stat(name: str) -> Dict[str, float]:
    return _STATS.setdefault(name, {"acquires": 0, "contended": 0,
                                    "wait_s": 0.0, "hold_s": 0.0})


def _held_stack() -> list:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
        with _RT:
            _STACKS.append(stack)
    return stack


def _note_acquired(name: str, contended: bool, wait: float) -> None:
    stack = _held_stack()
    with _RT:
        st = _stat(name)
        st["acquires"] += 1
        st["contended"] += 1 if contended else 0
        st["wait_s"] += wait
        for held, _t0 in stack:
            if held == name:
                continue
            _ORDER.setdefault(held, set()).add(name)
            # closing edge? then name ->* held already existed
            if (held, name) not in _CYCLE_PAIRS and \
                    _reaches_in(_ORDER, name, held):
                _CYCLE_PAIRS.add((held, name))
                _CYCLE_PAIRS.add((name, held))
                _CYCLES.append(
                    f"potential deadlock: `{held}` -> `{name}` acquired "
                    f"while the reverse order `{name}` -> `{held}` was "
                    "recorded earlier")
        stack.append((name, time.perf_counter()))


def _note_released(name: str) -> None:
    stack = _held_stack()
    with _RT:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _n, t0 = stack.pop(i)
                _stat(name)["hold_s"] += time.perf_counter() - t0
                return
        # released by another thread than the acquirer (legal for a
        # Lock): close the acquirer's entry, or it would fabricate order
        # edges for every lock that thread takes next
        for other in _STACKS:
            if other is stack:
                continue
            for i in range(len(other) - 1, -1, -1):
                if other[i][0] == name:
                    _n, t0 = other.pop(i)
                    _stat(name)["hold_s"] += time.perf_counter() - t0
                    return


class TracedLock:
    """``threading.Lock`` wrapper feeding the lock-order graph and the
    contention/hold counters; every acquire and release is also a
    :func:`sync_point` (``lock:<name>:acquire`` / ``:release``)."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()
        self._depth = threading.local()
        self._owner: Optional[int] = None   # holder ident (reentrant only)

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def _depth_get(self) -> int:
        return getattr(self._depth, "n", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sync_point(f"lock:{self.name}:acquire")
        if self._reentrant and self._depth_get() > 0:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._depth.n = self._depth_get() + 1
            return got
        t0 = time.perf_counter()
        got = self._inner.acquire(False)
        contended = not got
        if not got and blocking:
            got = self._inner.acquire(True, timeout)
        if got:
            _note_acquired(self.name, contended,
                           time.perf_counter() - t0)
            if self._reentrant:
                self._depth.n = self._depth_get() + 1
                self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        if self._reentrant:
            self._depth.n = self._depth_get() - 1
            if self._depth.n > 0:
                self._inner.release()
                return
            self._owner = None
        _note_released(self.name)
        self._inner.release()
        sync_point(f"lock:{self.name}:release")

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TracedRLock(TracedLock):
    """Reentrant :class:`TracedLock`: only the outermost acquire/release
    updates the order graph and the hold timer."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def locked(self) -> bool:
        return self._owner is not None


# ---------------------------------------------------------------------------
# deterministic interleavings
# ---------------------------------------------------------------------------

_SCHEDULE = None


def install_schedule(schedule) -> None:
    """Install a schedule (``SerialSchedule``, ``PointGate`` or anything
    with ``sync(key, point)``); :func:`clear_schedule` removes it. One
    global slot: schedules are a test facility, not production state."""
    global _SCHEDULE
    _SCHEDULE = schedule


def clear_schedule() -> None:
    global _SCHEDULE
    _SCHEDULE = None


def sync_point(point: str) -> None:
    """Named interleaving marker: a no-op (one global ``None`` check)
    unless a schedule is installed, which then decides when the calling
    thread may go on. Keys match as the bare ``point`` or as
    ``"<thread name>/<point>"``."""
    sched = _SCHEDULE
    if sched is None:
        return
    sched.sync(f"{threading.current_thread().name}/{point}", point)


class SerialSchedule:
    """Replay a prescribed total order of sync points across threads.

    ``order`` lists keys: ``"<thread>/<point>"`` for one thread's arrival,
    or a bare ``"<point>"`` for whichever thread arrives. A thread at a
    point in the remaining order blocks until its key is at the head;
    other points pass. A ``timeout`` expiry raises: a wedged schedule
    fails the test instead of hanging it.
    """

    def __init__(self, order: Sequence[str], timeout: float = 20.0):
        self._order = deque(order)
        self._cv = threading.Condition()
        self._timeout = timeout

    def sync(self, key: str, point: str) -> None:
        deadline = time.monotonic() + self._timeout
        with self._cv:
            while True:
                if not self._order or (key not in self._order
                                       and point not in self._order):
                    return
                head = self._order[0]
                if head in (key, point):
                    self._order.popleft()
                    self._cv.notify_all()
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"schedule wedged: {key!r} waited for head "
                        f"{head!r} (remaining order "
                        f"{list(self._order)!r})")
                self._cv.wait(remaining)

    def done(self) -> bool:
        with self._cv:
            return not self._order


class PointGate:
    """Hold named sync points closed until the test opens them.

    A thread reaching a listed point blocks; ``wait_arrival(point)``
    confirms that one is parked there and ``open(point)`` releases it and
    every later arrival. Entries are bare points (every thread) or
    ``"<thread name>/<point>"`` keys (one thread). Unlisted points pass.
    """

    def __init__(self, points: Sequence[str], timeout: float = 20.0):
        self._open = {p: threading.Event() for p in points}
        self._arrived = {p: threading.Event() for p in points}
        self._timeout = timeout

    def sync(self, key: str, point: str) -> None:
        # the thread-specific key wins over the bare point
        k = key if key in self._open else point
        ev = self._open.get(k)
        if ev is None:
            return
        self._arrived[k].set()
        if not ev.wait(self._timeout):
            raise TimeoutError(f"gate {k!r} never opened")

    def wait_arrival(self, point: str, timeout: Optional[float] = None
                     ) -> bool:
        return self._arrived[point].wait(timeout or self._timeout)

    def open(self, point: str) -> None:
        self._open[point].set()

    def open_all(self) -> None:
        for ev in self._open.values():
            ev.set()
