"""Span tracing and latency histograms (the spans half of
``openembedding_tpu/analysis/scope.py``).

* **Spans**: ``with span("checkpoint.save", mode="delta"): ...`` records
  one timed interval into the calling thread's ring buffer (each thread
  appends only to its own ring; the registry lock is taken once per
  thread) and into the histogram registry. A span opened while the
  current CUDA stream captures a graph records its event once, tagged
  ``trace_time``, and feeds no histogram: its body runs once per
  capture, not once per replay, as a JAX span's body runs once per
  compile. While a ``torch.profiler`` session records, a span also
  enters ``torch.profiler.record_function`` (where JAX enters a
  ``jax.profiler.TraceAnnotation``), so host spans nest inside device
  profiles. ``export_chrome_trace`` writes the rings as Chrome-trace /
  Perfetto JSON.
* **Histograms**: fixed log-spaced buckets (:data:`BUCKET_BOUNDS`, 4 a
  decade over 1e-7..1e12) shared by every series, quantiles by geometric
  interpolation inside the hit bucket, and Prometheus ``_bucket`` /
  ``_sum`` / ``_count`` rendering, byte-equal to the JAX package's.
* **Trace ids**: :func:`trace_context` scopes a request id that every
  span closed inside carries as its ``trace`` argument.

The JAX module's HLO byte ledger has no counterpart here.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import os
import re
import sys
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .concurrency import make_lock

# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

_TRACE_ENV = "OE_SCOPE_TRACE"


def _tracing_from_env() -> bool:
    return os.environ.get(_TRACE_ENV, "").lower() in ("1", "true", "yes",
                                                      "on")


_tracing = _tracing_from_env()


def set_tracing(on: Optional[bool]) -> None:
    """Force span-ring recording on/off; ``None`` restores the
    environment default (``OE_SCOPE_TRACE``, read here and at import, so
    no span pays for reading the environment). Histograms are always
    fed; only the per-event rings are gated."""
    global _tracing
    _tracing = _tracing_from_env() if on is None else bool(on)


def tracing_enabled() -> bool:
    return _tracing


def _trace_state_clean() -> bool:
    """False while the current CUDA stream captures a graph (the span's
    body then runs once per capture, not once per replay). True when
    torch or CUDA was never initialized: nothing can be capturing."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return True
    try:
        return not torch.cuda.is_current_stream_capturing()
    except Exception:  # noqa: BLE001 — any API drift reads as "clean"
        return True


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this process. A
    host-only process never pays for importing torch here."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:  # noqa: BLE001 — annotation is best-effort
        return False


def _profiler():
    """``torch.profiler.record_function`` while a torch profiler session
    records, else None: outside a session the annotation would only cost
    time."""
    if not profiling():
        return None
    return sys.modules["torch"].profiler.record_function


# ---------------------------------------------------------------------------
# request-scoped trace ids
# ---------------------------------------------------------------------------

_TRACE_ID: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("oe_trace_id", default=None)

TRACE_ID_CHARS = 16


def new_trace_id() -> str:
    return uuid.uuid4().hex[:TRACE_ID_CHARS]


def current_trace_id() -> Optional[str]:
    """The trace id of the enclosing :func:`trace_context`, or None."""
    return _TRACE_ID.get()


@contextlib.contextmanager
def trace_context(trace_id: Optional[str] = None):
    """Scope a trace/request id: spans recorded inside carry it as the
    ``trace`` arg of the exported trace. With no argument the enclosing
    id is reused if one is active, else a fresh one is minted."""
    tid = str(trace_id) if trace_id else (_TRACE_ID.get() or new_trace_id())
    token = _TRACE_ID.set(tid)
    try:
        yield tid
    finally:
        _TRACE_ID.reset(token)


# ---------------------------------------------------------------------------
# per-thread span rings
# ---------------------------------------------------------------------------

RING_CAPACITY = 65536

# one time origin for every ring: the exported trace is consistent across
# threads
_EPOCH = time.perf_counter()

_REG_LOCK = make_lock("scope.rings")
_RINGS: List["_Ring"] = []
# events of rings whose thread has exited, as (tid, name, event), bounded
_RETIRED: "deque" = deque(maxlen=RING_CAPACITY)
_retired_total = 0       # ever retired; minus len(_RETIRED) = dropped
_TLS = threading.local()


class _Ring:
    """One thread's span events; only the owner thread appends."""

    __slots__ = ("buf", "n", "tid", "name", "owner")

    def __init__(self, owner: threading.Thread):
        self.buf: List[tuple] = []
        self.n = 0          # total appended (>= len(buf) once wrapped)
        self.tid = owner.ident or 0
        self.name = owner.name
        self.owner = weakref.ref(owner)

    def append(self, ev: tuple) -> None:
        # a local snapshot of the buffer: a concurrent reset() swaps it
        # out, and a write into the old one is simply discarded
        buf = self.buf
        if len(buf) < RING_CAPACITY:
            buf.append(ev)
        else:
            try:
                buf[self.n % RING_CAPACITY] = ev
            except IndexError:
                buf.append(ev)
        self.n += 1

    @property
    def dropped(self) -> int:
        return max(0, self.n - RING_CAPACITY)


def _retire_dead_locked() -> None:
    """Fold rings of exited threads into the retired deque (the caller
    holds ``_REG_LOCK``)."""
    global _retired_total
    alive = []
    for ring in _RINGS:
        t = ring.owner()
        if t is not None and t.is_alive():
            alive.append(ring)
        else:
            for ev in list(ring.buf):
                _RETIRED.append((ring.tid, ring.name, ev))
                _retired_total += 1
    _RINGS[:] = alive


def _my_ring() -> _Ring:
    ring = getattr(_TLS, "ring", None)
    if ring is None:
        ring = _TLS.ring = _Ring(threading.current_thread())
        with _REG_LOCK:
            _retire_dead_locked()
            _RINGS.append(ring)
    return ring


def reset() -> None:
    """Drop every recorded span event (test isolation)."""
    global _retired_total
    with _REG_LOCK:
        for ring in _RINGS:
            ring.buf = []
            ring.n = 0
        _RETIRED.clear()
        _retired_total = 0


# nominal bytes per buffered span event, for the memory gauges
EVENT_NOMINAL_BYTES = 160


def ring_stats() -> Dict[str, int]:
    """Span-ring memory gauges for ``observability.memory_stats``."""
    with _REG_LOCK:
        events = sum(len(r.buf) for r in _RINGS) + len(_RETIRED)
        dropped = sum(r.dropped for r in _RINGS) \
            + (_retired_total - len(_RETIRED))
    return {"events": events, "dropped": max(0, dropped),
            "approx_bytes": events * EVENT_NOMINAL_BYTES}


# ---------------------------------------------------------------------------
# histogram registry
# ---------------------------------------------------------------------------

BUCKET_RATIO = 10.0 ** 0.25
BUCKET_BOUNDS: Tuple[float, ...] = tuple(10.0 ** (e / 4.0)
                                         for e in range(-28, 49))


class _Hist:
    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)   # +1: overflow
        self.sum = 0.0
        self.count = 0


def _labels_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class HistogramRegistry:
    """Named histograms and labeled counters over the shared bucket grid,
    thread-safe under one registry lock."""

    def __init__(self):
        self._lock = make_lock("scope.metrics")
        self._hists: Dict[Tuple[str, tuple], _Hist] = {}
        self._counters: Dict[Tuple[str, tuple], float] = {}

    def observe(self, name: str, value: float, **labels) -> None:
        self.observe_key((name, _labels_key(labels)), value)

    def observe_key(self, key: Tuple[str, tuple], value: float) -> None:
        """:meth:`observe` by the series' key, ``(name, sorted label
        pairs)``, built once by a caller that feeds one series often."""
        idx = bisect.bisect_left(BUCKET_BOUNDS, value)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.counts[idx] += 1
            h.sum += value
            h.count += 1

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def count(self, name: str, **labels) -> int:
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            return h.count if h is not None else 0

    def counter(self, name: str, **labels) -> float:
        """One labeled counter (0.0 when never bumped); with no labels,
        the sum over every label set of ``name``."""
        with self._lock:
            if labels:
                return self._counters.get((name, _labels_key(labels)), 0.0)
            return sum(v for (n, _l), v in self._counters.items()
                       if n == name)

    def sum(self, name: str, **labels) -> float:
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            return h.sum if h is not None else 0.0

    def quantile(self, name: str, q: float, **labels) -> float:
        """Quantile estimate by geometric interpolation inside the hit
        bucket (error within one :data:`BUCKET_RATIO`); NaN when empty."""
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            if h is None or h.count == 0:
                return float("nan")
            counts = list(h.counts)
            total = h.count
        target = max(1.0, q * total)
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(BUCKET_BOUNDS):      # overflow bucket
                    return BUCKET_BOUNDS[-1]
                hi = BUCKET_BOUNDS[i]
                lo = (BUCKET_BOUNDS[i - 1] if i > 0
                      else BUCKET_BOUNDS[0] / BUCKET_RATIO)
                frac = (target - cum) / c
                return lo * (hi / lo) ** frac
            cum += c
        return BUCKET_BOUNDS[-1]

    def series(self) -> List[Tuple[str, Dict[str, str]]]:
        with self._lock:
            return [(name, dict(labels))
                    for name, labels in sorted(self._hists)]

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
            self._counters.clear()

    def prometheus_lines(self, prefix: str = "oe") -> List[str]:
        """Every histogram as ``_bucket``/``_sum``/``_count`` series (zero
        buckets elided, ``+Inf`` always) and every counter as a
        ``_total``."""
        with self._lock:
            hists = {k: (list(h.counts), h.sum, h.count)
                     for k, h in self._hists.items()}
            counters = dict(self._counters)
        lines: List[str] = []
        last_name = None
        for (name, labels) in sorted(hists):
            counts, total_sum, total_count = hists[(name, labels)]
            base = f"{prefix}_{name}"
            if name != last_name:
                lines.append(f"# HELP {base} graftscope histogram "
                             f"`{name}` (log-spaced buckets)")
                lines.append(f"# TYPE {base} histogram")
                last_name = name
            cum = 0
            for i, c in enumerate(counts[:len(BUCKET_BOUNDS)]):
                if c == 0:
                    continue
                cum += c
                lab = _fmt_labels(labels,
                                  f'le="{BUCKET_BOUNDS[i]:.4g}"')
                lines.append(f"{base}_bucket{lab} {cum}")
            lab = _fmt_labels(labels, 'le="+Inf"')
            lines.append(f"{base}_bucket{lab} {total_count}")
            lab = _fmt_labels(labels)
            lines.append(f"{base}_sum{lab} {total_sum:.10g}")
            lines.append(f"{base}_count{lab} {total_count}")
        last_name = None
        for (name, labels) in sorted(counters):
            base = f"{prefix}_{name}_total"
            if name != last_name:
                lines.append(f"# HELP {base} graftscope counter "
                             f"`{name}`")
                lines.append(f"# TYPE {base} counter")
                last_name = name
            lines.append(f"{base}{_fmt_labels(labels)} "
                         f"{counters[(name, labels)]:.10g}")
        return lines


HISTOGRAMS = HistogramRegistry()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _hist_name(kind: str) -> str:
    return "span_" + re.sub(r"[^0-9A-Za-z]", "_", kind) + "_seconds"


def record_span(kind: str, t0: float, dt: float,
                labels: Optional[Mapping[str, Any]] = None, *,
                error: Optional[str] = None,
                trace_time: bool = False,
                detail: Optional[Mapping[str, Any]] = None) -> None:
    """Record one finished interval: a histogram sample (not for
    capture-time spans) and a ring event when tracing is on."""
    labels = labels or {}
    if not trace_time:
        HISTOGRAMS.observe(_hist_name(kind), dt, **labels)
        if error is not None:
            HISTOGRAMS.inc("span_errors", kind=kind, **labels)
    if tracing_enabled():
        det = dict(detail) if detail else None
        # the request trace id rides in the trace args only
        tid = _TRACE_ID.get()
        if tid is not None and (det is None or "trace" not in det):
            det = dict(det or {})
            det["trace"] = tid
        _my_ring().append((kind, t0, dt, dict(labels) or None, error,
                           trace_time, det))


class Span:
    """Context manager for one timed interval (see :func:`span`)."""

    __slots__ = ("kind", "labels", "detail", "t0", "_ann", "_trace_time")

    def __init__(self, kind: str, labels: Optional[dict] = None,
                 detail: Optional[dict] = None,
                 annotation: Optional[Any] = None):
        self.kind = kind
        self.labels = labels
        self.detail = detail
        self._ann = annotation

    def set_label(self, key: str, value: Any) -> "Span":
        """Attach or overwrite one histogram label before the span
        closes."""
        if self.labels is None:
            self.labels = {}
        self.labels[str(key)] = value
        return self

    def __enter__(self) -> "Span":
        self._trace_time = not _trace_state_clean()
        if self._ann is not None:
            try:
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 — the span must still run
                self._ann = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self.t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001 — the record must still land
                pass
        record_span(self.kind, self.t0, dt, self.labels,
                    error=exc_type.__name__ if exc_type else None,
                    trace_time=self._trace_time, detail=self.detail)
        return False


def _annotation(name: str):
    prof = _profiler()
    if prof is None:
        return None
    try:
        return prof(name)
    except Exception:  # noqa: BLE001 — annotation is best-effort
        return None


def span(kind: str, detail: Optional[Mapping[str, Any]] = None,
         **labels) -> Span:
    """Open a span: ``with span("pull", table="user"): ...``.

    ``labels`` become histogram labels and trace args (keep them
    low-cardinality); ``detail`` goes to the trace event only. Error
    exits are recorded with the exception type and re-raised."""
    return Span(kind, dict(labels) or None,
                dict(detail) if detail else None, _annotation(kind))


_STEP_SERIES = (_hist_name("step"), ())


def record_step(step: int, t0: float, dt: float,
                error: Optional[str] = None) -> None:
    """One train step's span, from the trainer's own clock readings
    (``utils/observability.py`` ``StepClock``; the step opens no
    :class:`Span`): a ``span_step_seconds`` sample, and while tracing is
    on the ring event, its step number in the args."""
    if error is None and not _tracing:
        HISTOGRAMS.observe_key(_STEP_SERIES, dt)
        return
    record_span("step", t0, dt, error=error, detail={"step": int(step)})


def enter_annotation(name: str):
    """Enter ``record_function(name)`` under a profiler session; returns
    what :func:`exit_annotation` closes, or None."""
    ann = _annotation(name)
    if ann is not None:
        try:
            ann.__enter__()
        except Exception:  # noqa: BLE001 — annotation is best-effort
            return None
    return ann


def exit_annotation(ann) -> None:
    if ann is not None:
        try:
            ann.__exit__(None, None, None)
        except Exception:  # noqa: BLE001 — annotation is best-effort
            pass


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def export_chrome_trace(path: Optional[str] = None, *,
                        process_name: Optional[str] = None
                        ) -> Dict[str, Any]:
    """Snapshot every thread's ring as Chrome-trace JSON; writes it to
    ``path`` when given. Timestamps are microseconds from the module's
    load-time origin, recorded as ``oeEpoch`` so several processes'
    captures merge onto one timeline (:func:`merge_chrome_traces`)."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    if process_name:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": str(process_name)}})

    def _event(tid: int, ev: tuple) -> Dict[str, Any]:
        kind, t0, dt, labels, error, trace_time, detail = ev
        args: Dict[str, Any] = dict(labels or {})
        if detail:
            args.update(detail)
        if error:
            args["error"] = error
        if trace_time:
            args["trace_time"] = True
        return {"name": kind, "ph": "X", "cat": "graftscope",
                "ts": (t0 - _EPOCH) * 1e6, "dur": dt * 1e6,
                "pid": pid, "tid": tid, "args": args}

    with _REG_LOCK:
        _retire_dead_locked()
        rings = [(r.tid, r.name, r.dropped, list(r.buf)) for r in _RINGS]
        retired = list(_RETIRED)
        retired_dropped = _retired_total - len(_RETIRED)
    if retired_dropped > 0:
        events.append({"ph": "M", "name": "graftscope_dropped",
                       "pid": pid, "tid": 0,
                       "args": {"retired_dropped": retired_dropped}})
    named = set()
    for tid, name, dropped, buf in rings:
        named.add((tid, name))
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
        if dropped:
            events.append({"ph": "M", "name": "graftscope_dropped",
                           "pid": pid, "tid": tid,
                           "args": {"dropped": dropped}})
        events.extend(_event(tid, ev) for ev in buf)
    for tid, name, ev in retired:
        if (tid, name) not in named:
            named.add((tid, name))
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        events.append(_event(tid, ev))
    events.sort(key=lambda e: e.get("ts", -1.0))
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "oeEpoch": _EPOCH}
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
    return trace


def merge_chrome_traces(base: Dict[str, Any],
                        others: List[Dict[str, Any]],
                        path: Optional[str] = None) -> Dict[str, Any]:
    """Fold traces of other processes into ``base`` on one timeline:
    each one's ``oeEpoch`` offsets its timestamps onto the base origin
    (``time.perf_counter`` is the system-wide monotonic clock on
    Linux)."""
    base_epoch = float(base.get("oeEpoch", 0.0))
    events = list(base.get("traceEvents", []))
    for tr in others:
        off_us = (float(tr.get("oeEpoch", base_epoch)) - base_epoch) * 1e6
        for e in tr.get("traceEvents", []):
            e = dict(e)
            if "ts" in e:
                e["ts"] = e["ts"] + off_us
            events.append(e)
    events.sort(key=lambda e: e.get("ts", -1.0))
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "oeEpoch": base_epoch}
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(merged, f)
    return merged
