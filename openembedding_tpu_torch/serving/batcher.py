"""Micro-batching lookup scheduler (the port's copy of
``openembedding_tpu/serving/batcher.py``): concurrent serving lookups
coalesce into one key-deduplicated batched pull.

Requests enter a BOUNDED queue; a flusher thread drains it when
``max_batch_rows`` rows accumulate or the oldest request has waited
``max_wait_us`` (an idle server adds at most one wait window of latency,
a loaded one batches to the row cap), and each flush resolves the whole
batch with ONE deduplicated pull per (variable, dtype, width) group,
scattering each request's rows back by position.

The contract, as in the JAX package (its ``protomodel.serving_batcher``
schedules replay against this module unchanged):

* responses are bit-identical to unbatched lookups: the pull is a pure
  gather, so dedup and the inverse scatter give exactly the rows a
  direct lookup gives;
* a batch reads exactly ONE model version: the flush takes the published
  state reference once (``serving.batch.snapshot``) and answers every
  member from it, even when a hot-swap lands mid-flush;
* every accepted request gets exactly one response: shutdown stops
  accepting and DRAINS what was accepted;
* a full (or closed) queue REJECTS new offers with :class:`BusyError`
  (HTTP 429), never accepting unbounded work.

The scheduler is generic over two hooks, ``snapshot()`` and
``pull_unique(snap, variable, unique_keys)`` (or ``pull_scatter``, which
also scatters), so the registry's device pull and the native host reader
ride the same scheduler. The sizing defaults live in ``utils.envconfig``;
:class:`AdaptiveBatchTuner` moves them online inside a ``PlanConfig``
envelope.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..analysis import scope
from ..analysis.concurrency import make_lock, sync_point
from ..utils import observability
# sizing defaults live in envconfig (ONE home for the batcher knobs —
# the load generator and the ServingConfig defaults read the same values):
# a 200 us window collects a handful of requests at the measured knee
# without adding visible latency at low load; 1024 rows caps one pull
# at ~64 coalesced 16-id storm requests
from ..utils import envconfig
from ..utils.envconfig import (DEFAULT_BATCH_QUEUE_ROWS,
                               DEFAULT_BATCH_ROWS, DEFAULT_BATCH_WAIT_US)

DEFAULT_MAX_BATCH_ROWS = DEFAULT_BATCH_ROWS
DEFAULT_MAX_WAIT_US = DEFAULT_BATCH_WAIT_US
DEFAULT_MAX_QUEUE_ROWS = DEFAULT_BATCH_QUEUE_ROWS


def knob_defaults() -> Dict[str, int]:
    """The batcher sizing defaults, read LIVE from their one home in
    ``utils.envconfig`` — every knob read (registry config fallbacks,
    CLI resolution) routes through here instead of snapshotting the
    constants at import time, so a retune (or a test monkeypatch) of
    the envconfig values is observed everywhere."""
    return {"max_batch_rows": int(envconfig.DEFAULT_BATCH_ROWS),
            "max_wait_us": int(envconfig.DEFAULT_BATCH_WAIT_US),
            "max_queue_rows": int(envconfig.DEFAULT_BATCH_QUEUE_ROWS)}


class BusyError(RuntimeError):
    """Bounded queue full (or batcher closed): the request was REJECTED
    without being enqueued — the serving 429 backpressure signal
    (``serving_rejected_total`` counts these)."""


class _Request:
    """One enqueued lookup: resolved by the flusher, awaited by the
    offering thread. The event is the cross-thread hand-off: ``rows``/
    ``error`` are written before ``done.set()`` and read only after
    ``done.wait()`` returns."""

    __slots__ = ("variable", "idx", "rows", "error", "done", "t_enq",
                 "trace_id")

    def __init__(self, variable: str, idx: np.ndarray,
                 trace_id: Optional[str]):
        self.variable = variable
        self.idx = idx
        self.rows: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t_enq = time.perf_counter()
        self.trace_id = trace_id

    def wait(self, timeout: float) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"batched lookup of {self.variable!r} timed out after "
                f"{timeout}s (flusher wedged?)")
        if self.error is not None:
            raise self.error
        return self.rows


def request_rows(idx: np.ndarray) -> int:
    """Row count of one flat query: [n] ids or [n, 2] pairs -> n."""
    return int(idx.shape[0]) if idx.ndim else 1


def dedup_keys(cat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique_keys, inverse)`` of a concatenated key stream — narrow
    [n] ids directly, wide [n, 2] int32 pairs deduped on their joined
    64-bit value (the unique PAIRS are returned, not the joins, so the
    pull sees the same representation the requests sent)."""
    if cat.ndim == 2:
        from ..hash_table import join64
        j64 = join64(cat)
        _uniq, first, inverse = np.unique(j64, return_index=True,
                                          return_inverse=True)
        return cat[first], inverse
    uniq, inverse = np.unique(cat, return_inverse=True)
    return uniq, inverse


class LookupBatcher:
    """One model's micro-batching scheduler (see module docstring).

    ``snapshot()`` is called ONCE per flush and must return the state
    view every pull of that flush reads (the registry returns the
    published ``(states, version)`` pair — one reference grab, the same
    discipline ``ServingModel.lookup`` pins for single lookups; the
    native path returns None, its mmap view is immutable after open).
    ``pull_unique(snap, variable, unique_keys)`` resolves one deduped
    key array to ``[n_unique, dim]`` float32 rows; alternatively
    ``pull_scatter(snap, variable, unique_keys, inverse)`` resolves AND
    scatters in one call (the native ``oe_pull_weights_gather`` entry
    point does both C-side).
    """

    def __init__(self, name: str,
                 snapshot: Callable[[], Any],
                 pull_unique: Optional[
                     Callable[[Any, str, np.ndarray], np.ndarray]],
                 *, pull_scatter: Optional[Callable[..., np.ndarray]] = None,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 max_wait_us: int = DEFAULT_MAX_WAIT_US,
                 max_queue_rows: int = DEFAULT_MAX_QUEUE_ROWS,
                 timeout: float = 30.0):
        if (pull_unique is None) == (pull_scatter is None):
            raise ValueError(
                "exactly one of pull_unique / pull_scatter is required")
        if max_batch_rows <= 0 or max_queue_rows <= 0 or max_wait_us < 0:
            raise ValueError("max_batch_rows/max_queue_rows must be > 0 "
                             "and max_wait_us >= 0")
        self.name = name
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_us = int(max_wait_us)
        self.max_queue_rows = int(max_queue_rows)
        self.timeout = float(timeout)
        self._snapshot = snapshot
        self._pull_unique = pull_unique
        self._pull_scatter = pull_scatter
        # the Condition guards every shared queue field below; the flusher holds it only for queue pops —
        # pulls run outside so offers never block on a device program
        self._cv = threading.Condition()
        # deque: a deep drain pops FIFO in O(1) per request — a list's
        # pop(0) would make exactly the oversubscribed case quadratic
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._queue_rows = 0
        self._accepting = True
        self._flushes = 0
        self._flush_rows = 0
        self._rejects = 0
        # daemon + joined by close(): a crashing host process must not
        # hang on the flusher, an orderly close() quiesces it
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"oe-batcher-{name}")
        self._thread.start()

    # -- client side --------------------------------------------------------
    def offer(self, variable: str, idx: np.ndarray) -> _Request:
        """Enqueue one flat lookup; raises :class:`BusyError` when the
        bounded queue is full or the batcher is closed (the caller maps
        it to 429-busy). The offer itself never blocks on a flush."""
        idx = np.asarray(idx)
        n = request_rows(idx)
        req = _Request(variable, idx, scope.current_trace_id())
        with self._cv:
            full = self._queue_rows + n > self.max_queue_rows
            if full and not self._queue and n > self.max_queue_rows:
                # a single request LARGER than the whole queue bound can
                # never be accepted by the row arithmetic — admit it
                # alone into the idle queue instead of rejecting it
                # forever (it flushes alone, see _pop_batch); with work
                # already queued it still gets the 429
                full = False
            if self._accepting and not full:
                self._queue.append(req)
                self._queue_rows += n
                self._cv.notify_all()
                accepted = True
            else:
                accepted = False
                self._rejects += 1
        if not accepted:
            sync_point("serving.batch.reject")
            # renders as oe_serving_rejected_total on /metrics
            observability.GLOBAL.add("serving_rejected")
            raise BusyError(
                f"batcher {self.name!r}: queue full "
                f"({self.max_queue_rows} rows) or closed — retry later")
        sync_point("serving.batch.enqueue")
        observability.record_serving_lookup(variable, idx.size)
        return req

    def lookup(self, variable: str, idx: np.ndarray,
               timeout: Optional[float] = None) -> np.ndarray:
        """Offer + wait: the drop-in replacement for a direct
        ``ServingModel.lookup`` on a flat query."""
        return self.offer(variable, idx).wait(timeout or self.timeout)

    # -- flusher ------------------------------------------------------------
    def _pop_batch(self) -> List[_Request]:
        """FIFO batch up to ``max_batch_rows`` (always >= 1 request;
        one oversized request still flushes alone). Caller holds no
        lock."""
        out: List[_Request] = []
        rows = 0
        with self._cv:
            while self._queue:
                n = request_rows(self._queue[0].idx)
                if out and rows + n > self.max_batch_rows:
                    break
                req = self._queue.popleft()
                self._queue_rows -= n
                out.append(req)
                rows += n
        return out

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and self._accepting:
                    self._cv.wait()
                if not self._queue and not self._accepting:
                    # drained after shutdown: every accepted request was
                    # answered before the flusher exits
                    return
                # adaptive flush: wait for more work until the ROW cap
                # or the oldest request's wait budget, whichever first.
                # The knobs are re-read every iteration (set_knobs
                # notifies this wait), so a live retune moves the very
                # next flush decision, not the one after.
                while self._accepting \
                        and self._queue_rows < self.max_batch_rows:
                    deadline = self._queue[0].t_enq \
                        + self.max_wait_us / 1e6
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            batch = self._pop_batch()
            if not batch:
                continue
            try:
                self._flush(batch)
            except BaseException as e:  # noqa: BLE001
                # _flush guards the per-group pulls, but snapshot() and
                # the observability epilogue run outside that guard: an
                # exception there must not kill the only flusher thread
                # (offers would still be accepted, then block their full
                # timeout — a silent whole-model outage). Deliver the
                # error to every still-unanswered member and keep
                # flushing; requests whose rows landed before the raise
                # are completed as-is.
                for r in batch:
                    if not r.done.is_set():
                        if r.rows is None and r.error is None:
                            r.error = e
                        r.done.set()

    def _flush(self, batch: List[_Request]) -> None:
        sync_point("serving.batch.collect")
        t0 = time.perf_counter()
        total_rows = sum(request_rows(r.idx) for r in batch)
        with self._cv:
            self._flushes += 1
            self._flush_rows += total_rows
        # ONE snapshot per flush: every pull below reads this reference
        # (the serving_batcher model's batch_serves_one_version
        # invariant; re-snapshotting per pull is the bug it forbids)
        sync_point("serving.batch.snapshot")
        snap = self._snapshot()
        # group by (variable, dtype, pair-width): only same-typed key
        # streams concatenate into one pull
        groups: Dict[Tuple[str, str, int], List[_Request]] = {}
        for req in batch:
            key = (req.variable, req.idx.dtype.str, req.idx.ndim)
            groups.setdefault(key, []).append(req)
        unique_total = 0
        member_traces = sorted({r.trace_id for r in batch if r.trace_id})
        with scope.span("serving.batch",
                        detail={"requests": len(batch),
                                "rows": total_rows,
                                "groups": len(groups),
                                "traces": member_traces}):
            for (variable, _dt, _nd), reqs in groups.items():
                try:
                    cat = np.concatenate([r.idx for r in reqs]) \
                        if len(reqs) > 1 else reqs[0].idx
                    uniq, inverse = dedup_keys(cat)
                    unique_total += request_rows(uniq)
                    sync_point("serving.batch.pull")
                    with scope.span("serving.batch.pull", table=variable):
                        if self._pull_scatter is not None:
                            scattered = np.asarray(self._pull_scatter(
                                snap, variable, uniq, inverse))
                        else:
                            rows = np.asarray(
                                self._pull_unique(snap, variable, uniq))
                            scattered = rows[inverse]
                    off = 0
                    for r in reqs:
                        n = request_rows(r.idx)
                        r.rows = scattered[off:off + n]
                        off += n
                except BaseException as e:  # noqa: BLE001 — delivered to
                    # every waiter of THIS group; other groups proceed
                    for r in reqs:
                        r.error = e
        dt = time.perf_counter() - t0
        scope.HISTOGRAMS.observe("serving_batch_rows", float(total_rows))
        scope.HISTOGRAMS.observe("serving_batch_requests",
                                 float(len(batch)))
        observability.GLOBAL.add("batch_flushes")
        observability.GLOBAL.add("batch_requests", float(len(batch)))
        observability.GLOBAL.add("batch_rows", float(total_rows))
        observability.GLOBAL.add("batch_unique_rows", float(unique_total))
        sync_point("serving.batch.respond")
        for r in batch:
            # per-member batch leg: carries the MEMBER's request trace
            # id, so a merged Perfetto trace shows each request joining
            # its coalesced flush
            scope.HISTOGRAMS.observe("serving_batch_wait_us",
                                     (t0 - r.t_enq) * 1e6)
            scope.record_span("serving.batch.member", r.t_enq,
                              time.perf_counter() - r.t_enq,
                              {"table": r.variable},
                              detail={"trace": r.trace_id,
                                      "requests": len(batch)})
            r.done.set()

    # -- lifecycle ----------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, DRAIN the accepted queue (every enqueued
        request gets its response — the model's
        no_request_lost_at_shutdown invariant), join the flusher."""
        sync_point("serving.batch.shutdown")
        with self._cv:
            self._accepting = False
            self._cv.notify_all()
        self._thread.join(timeout)

    # -- live knobs ---------------------------------------------------------
    def knobs(self) -> Dict[str, int]:
        """Current sizing knobs, read under the queue lock — THE live
        accessor every external knob read goes through (the registry's
        admission gate, warmup ladder, and the adaptive tuner)."""
        with self._cv:
            return {"max_batch_rows": self.max_batch_rows,
                    "max_wait_us": self.max_wait_us,
                    "max_queue_rows": self.max_queue_rows}

    def set_knobs(self, max_batch_rows: Optional[int] = None,
                  max_wait_us: Optional[int] = None,
                  max_queue_rows: Optional[int] = None) -> Dict[str, int]:
        """Retune the sizing knobs while the flusher runs. Updates land
        under the queue lock and wake the flusher, so the very next
        flush decision observes them (the flusher reads the knobs per
        loop iteration — never a cached copy). Returns the new knobs."""
        with self._cv:
            if max_batch_rows is not None:
                self.max_batch_rows = max(1, int(max_batch_rows))
            if max_wait_us is not None:
                self.max_wait_us = max(0, int(max_wait_us))
            if max_queue_rows is not None:
                self.max_queue_rows = max(1, int(max_queue_rows))
            self._cv.notify_all()
            return {"max_batch_rows": self.max_batch_rows,
                    "max_wait_us": self.max_wait_us,
                    "max_queue_rows": self.max_queue_rows}

    def stats(self) -> Dict[str, float]:
        with self._cv:
            return {"queue_rows": float(self._queue_rows),
                    "queued_requests": float(len(self._queue)),
                    "flushes": float(self._flushes),
                    "flush_rows": float(self._flush_rows),
                    "rejects": float(self._rejects)}

    def __enter__(self) -> "LookupBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- the online tuner -------------------------------------------------------

# flush-occupancy deadband: pressure UP above the high mark, DOWN below
# the low mark, and NO step in between — combined with the consecutive-
# sample hysteresis this is what keeps a load oscillating at a threshold
# from flapping the knobs
UP_OCCUPANCY = 0.85
DOWN_OCCUPANCY = 0.30


class AdaptiveBatchTuner:
    """Hysteresis-bounded online tuner for one batcher's sizing knobs.

    Samples the batcher every ``plan.adjust_interval_ms``: flush
    occupancy (rows flushed per flush vs ``max_batch_rows``), queue
    backlog, and 429 rejects since the last sample. Sustained pressure
    (``hysteresis`` consecutive out-of-band samples) steps BOTH knobs
    by ``step_factor`` — up under backlog (bigger flushes amortize the
    per-pull dispatch; the wait window is moot because the row cap
    flushes first), down when sustained idle (small fast flushes bound
    the latency an idle server adds). Steps clamp to the PlanConfig
    floor/ceiling and never move silently: every applied step counts as
    ``oe_plan_adjust_total{knob=,direction=}`` on /metrics.

    ``stop()`` is the kill switch: it joins the sampler and (by
    default) restores the static knobs the batcher was configured
    with, so disarming mid-run returns the exact pre-tuner behavior.
    """

    def __init__(self, batcher: LookupBatcher,
                 plan: "envconfig.PlanConfig", *,
                 up_occupancy: float = UP_OCCUPANCY,
                 down_occupancy: float = DOWN_OCCUPANCY):
        self._b = batcher
        self._plan = plan
        self._up = float(up_occupancy)
        self._down = float(down_occupancy)
        self._static = batcher.knobs()      # restored by the kill switch
        # guards the sampler state below: the interval thread and a
        # test (or operator) driving sample() directly must not
        # interleave one observation->decision round with another
        self._lock = make_lock(f"serving.plan.{batcher.name}")
        self._last = batcher.stats()
        self._streak = 0                    # signed run of same-direction samples
        self._adjustments = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"oe-plan-{batcher.name}")
        self._thread.start()

    # -- sampling loop ------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._plan.adjust_interval_ms / 1e3):
            self.sample()

    def _direction(self, s: Dict[str, float],
                   knobs: Dict[str, int]) -> int:
        """+1 pressure up, -1 sustained idle, 0 inside the deadband."""
        flushes = s["flushes"] - self._last["flushes"]
        rows = s["flush_rows"] - self._last["flush_rows"]
        rejects = s["rejects"] - self._last["rejects"]
        occupancy = rows / (flushes * knobs["max_batch_rows"]) \
            if flushes else 0.0
        if rejects > 0 or s["queue_rows"] > knobs["max_batch_rows"] \
                or (flushes and occupancy >= self._up):
            return 1
        if flushes and occupancy <= self._down \
                and s["queue_rows"] == 0:
            return -1
        return 0            # deadband, or no traffic at all this window

    def sample(self) -> int:
        """One observation->decision round (the thread calls this every
        interval; tests drive it directly for determinism). Returns the
        number of knob steps applied (0 or 1)."""
        with self._lock:
            s = self._b.stats()
            knobs = self._b.knobs()
            d = self._direction(s, knobs)
            self._last = s
            if d == 0 or (self._streak and (d > 0) != (self._streak > 0)):
                self._streak = d    # deadband or direction flip: restart
                return 0
            self._streak += d
            if abs(self._streak) < self._plan.hysteresis:
                return 0
            self._streak = 0
            return self._apply(knobs, up=d > 0)

    def _apply(self, knobs: Dict[str, int], *, up: bool) -> int:
        p, f = self._plan, self._plan.step_factor
        scale = f if up else 1.0 / f
        rows = min(p.rows_ceiling,
                   max(p.rows_floor,
                       int(knobs["max_batch_rows"] * scale)))
        wait = min(p.wait_ceiling_us,
                   max(p.wait_floor_us,
                       int(knobs["max_wait_us"] * scale)))
        changed = {}
        if rows != knobs["max_batch_rows"]:
            changed["max_batch_rows"] = rows
        if wait != knobs["max_wait_us"]:
            changed["max_wait_us"] = wait
        if not changed:
            return 0                # pinned at the envelope edge: no flap
        sync_point("serving.plan.adjust")
        self._b.set_knobs(**changed)
        direction = "up" if up else "down"
        for knob in changed:
            observability.add_labeled("plan_adjust", knob=knob,
                                      direction=direction)
        self._adjustments += 1
        return 1

    # -- lifecycle ----------------------------------------------------------
    @property
    def adjustments(self) -> int:
        with self._lock:
            return self._adjustments

    def stop(self, restore: bool = True, timeout: float = 10.0) -> None:
        """Kill switch: join the sampler; ``restore`` re-applies the
        static knobs the batcher was configured with."""
        self._stop.set()
        self._thread.join(timeout)
        if restore:
            self._b.set_knobs(**self._static)
