"""Observability: scoped timers, counters, gauges, the Prometheus page,
the periodic reporter and a streaming AUC (the port's copy of
``openembedding_tpu/utils/observability.py``).

``Accumulator`` counters and ``vtimer`` timers are process-local host
counters; the last-value gauges (checkpoint chain length and write rate,
the serving hot-swap version) and labeled gauges sit beside them;
``record_ckpt_save`` and ``record_swap`` feed the delta checkpoint and
hot-swap ledgers, ``record_batch_stats`` the trainer's and the server's
batch-shape gauges and ``record_serving_lookup`` the server's lookup-size
histogram; ``add_labeled`` is a labeled counter; ``prometheus_text`` renders everything (with the span
histograms of ``analysis/scope.py`` and the host-memory ledger) in the
text exposition format, line for line the JAX package's. Host timings
and host reads mean nothing inside a CUDA graph capture, where the
code runs once per capture: ``under_trace`` reports a capture as JAX's
reports a trace. ``plane_timed``/``plane_timings`` time the sharded
planes' pulls and pushes (``parallel/``) under the gate; the hot-row
cache's ``cache_stats`` comes with its plane (ROADMAP Queue 1,
multi-shard exchange planes).

The train step times itself from inside, which the JAX package does not:
``stage`` marks (``pull``, ``dense``, ``push``, xDeepFM's ``dense.cin``
and the tables' ``push.dedup``, ``push.find``, ``push.update``) and
``stage_grad`` marks in the backward pass (``dense.cin_grad``) record
CUDA events inside the captured graph of an armed step program (one
built while the gate is on) and read the host's clock on the CPU; ``StepClock`` reads the host's
clock at the phase boundaries of ``Trainer.train_step`` (``stats``,
``prepare``, ``lookup``, ``copy``, ``launch``, ``output``, ``after``)
and feeds the step's span.
``step_timings`` returns both; ``prometheus_text`` renders them as the
``oe_step_host_*`` and ``oe_step_device_*`` families, and ``Reporter``
prints them. ``prometheus_text`` also shows the hash find-or-insert
kernels' key counters (``oe_hash_find_keys_total{outcome=}``), zeros
until a kernel has run.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..analysis import scope
from ..analysis.concurrency import make_lock, sync_point

_EVALUATE_PERFORMANCE = False


def set_evaluate_performance(on: bool) -> None:
    """Global gate like the reference's pico_is_evaluate_performance()."""
    global _EVALUATE_PERFORMANCE
    _EVALUATE_PERFORMANCE = bool(on)


def evaluate_performance() -> bool:
    return _EVALUATE_PERFORMANCE


class Accumulator:
    """Named monotonic counters + timing sums (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = collections.defaultdict(float)
        self._times: Dict[str, float] = collections.defaultdict(float)
        self._calls: Dict[str, int] = collections.defaultdict(int)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self._times[name] += seconds
            self._calls[name] += 1

    def calls(self, name: str) -> int:
        """How many times ``add_time(name, ...)`` has run (cheap read)."""
        with self._lock:
            return self._calls.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {name: {"count": v} for name, v in self._counts.items()}
            for name, t in self._times.items():
                out.setdefault(name, {})["seconds"] = t
                out[name]["calls"] = self._calls[name]
                if self._calls[name]:
                    out[name]["avg_ms"] = 1000.0 * t / self._calls[name]
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._times.clear()
            self._calls.clear()


# process-global default, like the reference's Accumulator client singleton
GLOBAL = Accumulator()


@contextlib.contextmanager
def vtimer(name: str, accumulator: Optional[Accumulator] = None):
    """Scoped timer (VTIMER equivalent). No-op-cheap when not reporting."""
    acc = accumulator or GLOBAL
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc.add_time(name, time.perf_counter() - t0)


# always-on batch-shape gauges: when the evaluate_performance gate is
# OFF, the uniqueness scan still runs — but at most once per table per
# this window, so a production trainer pays ~one np.unique per second
# per table instead of one per batch. The dict is read/written without
# a lock: batches for one table come from one trainer thread, and the
# worst a race costs is one extra scan.
_BATCH_GAUGE_INTERVAL_S = 1.0
_BATCH_GAUGE_LAST: Dict[str, float] = {}


def record_batch_stats(sparse: Dict[str, Any],
                       accumulator: Optional[Accumulator] = None,
                       view: Optional[Callable[[Any], np.ndarray]] = None
                       ) -> None:
    """Per-table batch-shape stats for one batch (host-side). ``view``
    turns a column into the host array that is scanned; it is called only
    for a column the throttle lets through (the trainer's copies a
    device-resident column to the host).

    Two tiers:

    * ALWAYS ON — last-value gauges ``pull_unique_ratio_last`` /
      ``pull_key_skew_last`` per table (``/metrics``), throttled to one
      uniqueness scan per table per second when the gate is off, so a
      production stats window can be captured without arming the debug
      gate (first batch of a table always records, whatever the clock).
    * Gated by set_evaluate_performance like the reference
      (EmbeddingPullOperator.cpp:208-209,244-248) — the pull_indices /
      pull_unique counters and the full per-table histograms
      (``pull_rows``/``pull_unique_ratio``/``pull_key_skew``), fed
      every batch.
    """
    acc = accumulator or GLOBAL
    gated = _EVALUATE_PERFORMANCE
    for name, idx in sparse.items():
        if not gated:
            last = _BATCH_GAUGE_LAST.get(name)
            now = time.monotonic()
            if last is not None and now - last < _BATCH_GAUGE_INTERVAL_S:
                continue
        arr = np.asarray(idx if view is None else view(idx)).ravel()
        _uniq, counts = np.unique(arr, return_counts=True)
        if gated:
            acc.add("pull_indices", arr.size)
            acc.add("pull_unique", _uniq.size)
        if arr.size:
            _BATCH_GAUGE_LAST[name] = time.monotonic()
            set_labeled_gauge("pull_unique_ratio_last",
                              _uniq.size / arr.size, table=name)
            set_labeled_gauge("pull_key_skew_last",
                              counts.max() / arr.size, table=name)
        if gated and arr.size:
            # per-table batch-shape distributions (graftscope histogram
            # registry -> /metrics _bucket series): rows per batch, the
            # dedup win, and key skew as the top-1 key's share
            scope.HISTOGRAMS.observe("pull_rows", float(arr.size),
                                     table=name)
            scope.HISTOGRAMS.observe("pull_unique_ratio",
                                     _uniq.size / arr.size, table=name)
            scope.HISTOGRAMS.observe("pull_key_skew",
                                     counts.max() / arr.size, table=name)


def record_ingest_stall(seconds: float, *,
                        accumulator: Optional[Accumulator] = None,
                        **labels) -> None:
    """Per-step ingest stall accounting: the time one step's batch pull
    blocked on data. Feeds the ``ingest_stall`` timer and the
    ``ingest_stall_ms`` histogram; a step that found its batch ready
    records exactly ``0.0``, so "the step never blocks on data after
    warm-up" is checkable as a p95 of zero."""
    acc = accumulator or GLOBAL
    acc.add_time("ingest_stall", seconds)
    scope.HISTOGRAMS.observe("ingest_stall_ms", seconds * 1e3, **labels)


def ingest_stall_records(accumulator: Optional[Accumulator] = None) -> int:
    """Number of ``ingest_stall`` entries recorded so far. ``Trainer.fit``
    reads it around each batch fetch to see, through any iterator
    wrapper, whether the source recorded its own wait (a ``ShardStream``
    behind ``itertools.chain`` loses its ``ingest_accounted`` mark but
    still records each pop), so no wait is counted twice."""
    return (accumulator or GLOBAL).calls("ingest_stall")


def record_serving_lookup(name: str, size: float,
                          accumulator: Optional[Accumulator] = None) -> None:
    """Serving-side statistics of ONE lookup request, always on (one
    histogram bump): the ``serving_lookup_requests`` and
    ``serving_lookup_ids`` counters and the per-variable lookup-size
    distribution ``serving_lookup_rows{table=...}``, which the
    micro-batcher is sized from. ``size`` is the request's number of
    index ELEMENTS (a wide ``[n, 2]`` pair query counts 2n, its wire
    volume)."""
    acc = accumulator or GLOBAL
    acc.add("serving_lookup_requests", 1.0)
    acc.add("serving_lookup_ids", float(size))
    scope.HISTOGRAMS.observe("serving_lookup_rows", float(size),
                             table=str(name))


def cache_stats(accumulator: Optional[Accumulator] = None
                ) -> Dict[str, float]:
    """The hot-row replica's counters (``parallel/hot_cache.py``):
    ``cache_hits`` and ``cache_misses`` (batch entries against the
    replica), ``ici_bytes_saved`` (exchange bytes the hits skipped) and
    ``cache_hit_rate``, hits over both. Recorded only while
    :func:`set_evaluate_performance` is on."""
    snap = (accumulator or GLOBAL).snapshot()

    def _count(name: str) -> float:
        return snap.get(name, {}).get("count", 0.0)

    hits = _count("cache_hits")
    misses = _count("cache_misses")
    total = hits + misses
    return {"cache_hits": hits, "cache_misses": misses,
            "ici_bytes_saved": _count("ici_bytes_saved"),
            "cache_hit_rate": hits / total if total else 0.0}


def under_trace(tree=None) -> bool:
    """True while the current CUDA stream captures a graph: host-side
    timers and counters must not record there (the host code runs once
    per capture, not once per replay). ``tree`` is accepted for the JAX
    signature; a capture, not the arguments, decides."""
    del tree
    return not scope._trace_state_clean()


def plane_timed(verb: str, plane: str, enabled: bool, fn, *args):
    """Run one data-plane dispatch with a gated per-plane wall timer, as
    JAX's: ``enabled`` is the caller's snapshot of
    :func:`evaluate_performance` (off by default: the timer waits for the
    device, which would serialize the step). Timings land under
    ``<verb>/<plane>`` (``pull/a2a``, ``push/psum``) and as a span; read
    them back with :func:`plane_timings`. A dispatch inside a CUDA graph
    capture records nothing (it runs once per capture, not per replay),
    as JAX's skips dispatches inside an outer jit."""
    if not enabled or under_trace(args):
        return fn(*args)
    import torch

    def _wait():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    _wait()
    t0 = time.perf_counter()
    try:
        out = fn(*args)
        _wait()
    except BaseException as e:
        # a raising dispatch still consumed its wall time
        dt = time.perf_counter() - t0
        GLOBAL.add_time(f"{verb}/{plane}", dt)
        scope.record_span(verb, t0, dt, {"plane": plane},
                          error=type(e).__name__)
        raise
    dt = time.perf_counter() - t0
    GLOBAL.add_time(f"{verb}/{plane}", dt)
    scope.record_span(verb, t0, dt, {"plane": plane})
    return out


# --- step timings: the device stages of an armed step program, the host
# phases of Trainer.train_step --------------------------------------------

_STAGES = threading.local()          # .recorder: the marks being recorded


def stage(name: str) -> None:
    """Open the stage ``name`` on the current stream: a segment runs from
    one mark to the next in stream order and is added to the stage that
    opened it; ``a.b`` is added to ``a`` too (``push.find`` to ``push``).
    Nothing happens unless a :class:`StageRecorder` records on this
    thread, which the trainer arranges only while it builds or, on the
    CPU, runs an armed step program (``training.py``)."""
    rec = getattr(_STAGES, "recorder", None)
    if rec is not None:
        rec.mark(name)


def stage_grad(x, name: str):
    """``x``, or a view of it that the backward pass leaves unchanged and
    that opens the stage ``name`` once ``x``'s gradient is complete (a
    tensor hook), where a :class:`StageRecorder` records on this thread and
    gradients are on. Autograd runs a card's backward on a thread of its
    own, where no recorder records, so the hook takes this thread's
    recorder along; it marks on the stream the backward runs on, the
    forward's. Like :func:`stage`, nothing happens unless a recorder
    records, and an unarmed program holds no hook."""
    rec = getattr(_STAGES, "recorder", None)
    if rec is None or not x.requires_grad:
        return x
    import torch
    if not torch.is_grad_enabled():
        return x
    x = x.view_as(x)
    x.register_hook(lambda _grad: rec.mark(name))
    return x


class StageRecorder:
    """The stage marks of one armed step program.

    On a CUDA device each mark records a timing event on the current
    stream with ``external=True``: inside a graph capture it becomes an
    event-record node of the graph (not a kernel, copy or fill), which
    every replay records again, and the marks cost nothing in a program
    built unarmed, which holds none. On the CPU, where operations run as
    they are called, a mark reads the host's clock."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: list = []

    def mark(self, name: str) -> None:
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    @contextlib.contextmanager
    def recording(self):
        """Marks of :func:`stage` calls on this thread, in the ``with``
        body, go to this recorder."""
        prev = getattr(_STAGES, "recorder", None)
        _STAGES.recorder = self
        try:
            yield self
        finally:
            _STAGES.recorder = prev

    def seconds(self) -> Dict[str, float]:
        """Seconds by stage of the last run, after waiting for its last
        mark."""
        out: Dict[str, float] = {}
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[name] = out.get(name, 0.0) + dt
            if "." in name:
                top = name.split(".", 1)[0]
                out[top] = out.get(top, 0.0) + dt
        return out


_STEP_LOCK = make_lock("observability.steps")
_PENDING: Optional[StageRecorder] = None    # the last armed run, unread
_DEVICE: Dict[str, list] = {}               # stage -> [seconds, replays]

HOST_PHASES = ("stats", "prepare", "lookup", "copy", "launch", "output",
               "after")
# seconds by phase, then the whole call's ("step"); counted steps
_HOST_SECONDS = [0.0] * (len(HOST_PHASES) + 1)
_HOST_CALLS = [0]


def _read_pending_locked() -> None:
    global _PENDING
    rec, _PENDING = _PENDING, None
    if rec is not None:
        for name, dt in rec.seconds().items():
            d = _DEVICE.setdefault(name, [0.0, 0])
            d[0] += dt
            d[1] += 1


def stages_before_run() -> None:
    """Read the previous armed run's stages (waiting for its end) before
    the next armed run records the same events again."""
    with _STEP_LOCK:
        _read_pending_locked()


def stages_after_run(recorder: StageRecorder) -> None:
    """One armed run (a replay, or an eager call) was launched; its
    stages are read before the next armed run or at
    :func:`step_timings`."""
    global _PENDING
    with _STEP_LOCK:
        _PENDING = recorder


class StepClock:
    """The host phases of one ``Trainer.train_step``, on the host's clock.

    The clock reads ``time.perf_counter()`` as the step starts; each
    :meth:`mark` ends the current phase of :data:`HOST_PHASES` and opens
    the next, and :meth:`close` ends the last (``after``) and the step.
    A counted step adds each phase's seconds, and the whole call's as
    ``step``, to plain floats in one process-wide store (the trainer is
    one thread); every step, counted or not, feeds the
    ``span_step_seconds`` histogram from the same readings
    (``scope.record_step``). Under a ``torch.profiler`` session the step
    enters ``record_function("step <n>")`` and each phase
    ``record_function("step.<phase>")``, so a profile puts the host's
    gaps between device work down to a phase."""

    __slots__ = ("step", "t", "_ann", "_step_ann")

    def __init__(self, step: int, profiling: bool):
        self.step = step
        self._ann = self._step_ann = None
        if profiling:
            self._step_ann = scope.enter_annotation(f"step {step}")
            self._ann = scope.enter_annotation("step." + HOST_PHASES[0])
        self.t = [time.perf_counter()]

    def mark(self) -> None:
        self.t.append(time.perf_counter())
        if self._step_ann is not None:
            scope.exit_annotation(self._ann)
            n = len(self.t) - 1
            self._ann = scope.enter_annotation("step." + HOST_PHASES[n]) \
                if n < len(HOST_PHASES) else None

    def close(self, counted: bool, error: Optional[str] = None) -> None:
        """End the step; ``counted``: add its phases to the store (only a
        step that took every phase is)."""
        t = self.t
        t.append(time.perf_counter())
        if self._step_ann is not None:
            scope.exit_annotation(self._ann)
            scope.exit_annotation(self._step_ann)
        dt = t[-1] - t[0]
        scope.record_step(self.step, t[0], dt, error)
        if counted and len(t) == len(HOST_PHASES) + 1:
            s = _HOST_SECONDS
            for i in range(len(HOST_PHASES)):
                s[i] += t[i + 1] - t[i]
            s[-1] += dt
            _HOST_CALLS[0] += 1


def step_timings() -> Dict[str, Dict[str, Dict[str, float]]]:
    """The step's timings so far: ``{"host": {phase: {"seconds",
    "calls"}}, "device": {stage: {"seconds", "replays"}}}``.

    ``host``: each phase of :data:`HOST_PHASES` and ``step``, the whole
    ``Trainer.train_step`` call, over the counted steps: a step that
    built a program, or ran while a profiler session recorded (the
    profiler's own cost would read as host time), is not counted.
    ``copy`` is the batch's copy into the step program's buffers, and
    holds the wait for the card's previous step where the batch lies in
    pageable memory (such a copy waits for its stream once the driver's
    staging buffer fills).

    ``device``: the stages of the armed runs (:func:`stage`,
    :func:`stage_grad`; ``pull``, ``dense`` and xDeepFM's parts
    ``dense.cin``, ``dense.cin_grad``, ``push`` and its parts
    ``push.dedup``, ``push.find``, ``push.update``), in device seconds
    on CUDA, and ``replays`` the armed runs that held each. A step program is armed when
    :func:`evaluate_performance` is on at its build (a profiler session
    does not arm it: a trace shows the program users run); a build's
    warm-up is not counted. The last armed run is read
    here, after waiting for it. Its cost: while armed, at most one replay
    is in flight (each armed run first waits for the one before), as
    :func:`plane_timed`'s timers serialize the step."""
    with _STEP_LOCK:
        _read_pending_locked()
        device = {k: {"seconds": v[0], "replays": v[1]}
                  for k, v in sorted(_DEVICE.items())}
    names = HOST_PHASES + ("step",)
    host = {p: {"seconds": _HOST_SECONDS[i], "calls": _HOST_CALLS[0]}
            for i, p in enumerate(names)}
    return {"host": host, "device": device}


def reset_step_timings() -> None:
    """Forget every step timing, the unread armed run too."""
    global _PENDING
    with _STEP_LOCK:
        _PENDING = None
        _DEVICE.clear()
        _HOST_SECONDS[:] = [0.0] * len(_HOST_SECONDS)
        _HOST_CALLS[0] = 0


def _step_report() -> list:
    """The step timings as :class:`Reporter` prints them: milliseconds a
    counted step by host phase, a replay by device stage; empty parts are
    left out."""
    st = step_timings()
    out = []
    calls = st["host"]["step"]["calls"]
    if calls:
        fields = ", ".join(f"{p}_ms={1e3 * v['seconds'] / calls:.6g}"
                           for p, v in st["host"].items())
        out.append(f"step_host[{fields}, calls={calls}]")
    if st["device"]:
        fields = ", ".join(
            f"{k}_ms={1e3 * v['seconds'] / v['replays']:.6g}"
            for k, v in st["device"].items())
        out.append(f"step_device[{fields}]")
    return out


def _step_lines(prefix: str) -> list:
    """The four ``<prefix>_step_*`` families of :func:`step_timings`."""
    st = step_timings()
    lines = []
    for part, label, field, kind, help_txt in (
            ("host", "phase", "seconds", "seconds",
             "host seconds of Trainer.train_step by phase, counted steps"),
            ("host", "phase", "calls", "calls",
             "counted Trainer.train_step calls by phase"),
            ("device", "stage", "seconds", "seconds",
             "device seconds of armed step runs by stage"),
            ("device", "stage", "replays", "replays",
             "armed step runs by stage")):
        base = f"{prefix}_step_{part}_{kind}_total"
        lines.append(f"# HELP {base} {help_txt}")
        lines.append(f"# TYPE {base} counter")
        for name, v in st[part].items():
            lines.append(f'{base}{{{label}="{_esc_label(name)}"}} '
                         f"{v[field]:.10g}")
    return lines


def _hash_find_lines(prefix: str) -> list:
    """``<prefix>_hash_find_keys_total{outcome=}``: the keys the
    find-or-insert kernels (``ops/find_or_insert.py``) found, inserted and
    failed to place, zeros before a kernel has run in this process. Read
    from the card at the scrape: the scrape waits on the current stream
    of each device the kernels ran on."""
    from ..ops import find_or_insert as k3
    base = f"{prefix}_hash_find_keys_total"
    lines = [f"# HELP {base} keys the hash find-or-insert kernels found, "
             "inserted or failed to place",
             f"# TYPE {base} counter"]
    for outcome, v in k3.key_counts().items():
        lines.append(f'{base}{{outcome="{outcome}"}} {v}')
    return lines


def plane_timings(accumulator: Optional[Accumulator] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Per-plane pull/push wall-time split recorded by :func:`plane_timed`
    (and ``step/<plane>`` where a caller records whole steps): ``{plane:
    {"pull_ms": avg, "pull_calls": n, "push_ms": ..., ...}}``, empty
    unless the gate was on while the planes ran. With step, pull and push
    samples, ``stage_serial_ms`` is the recorded pull and push time per
    step and ``overlap_hidden_ms`` that minus ``step_ms``, as in JAX."""
    snap = (accumulator or GLOBAL).snapshot()
    out: Dict[str, Dict[str, float]] = {}
    for name, fields in snap.items():
        if "/" not in name:
            continue
        verb, plane = name.split("/", 1)
        if verb not in ("pull", "push", "step") or "calls" not in fields:
            continue
        d = out.setdefault(plane, {})
        d[f"{verb}_ms"] = fields.get("avg_ms", 0.0)
        d[f"{verb}_calls"] = fields["calls"]
    for plane, d in out.items():
        if "step_ms" in d and "pull_ms" in d and "push_ms" in d:
            stage_total = d["pull_ms"] * d["pull_calls"] \
                + d["push_ms"] * d["push_calls"]
            d["stage_serial_ms"] = stage_total / max(1.0, d["step_calls"])
            d["overlap_hidden_ms"] = d["stage_serial_ms"] - d["step_ms"]
    return out


def lock_stats() -> Dict[str, Dict[str, float]]:
    """Per-lock runtime counters from the graftrace detector
    (``analysis/concurrency.py`` TracedLock): ``acquires``, ``contended``
    (acquire found the lock held), ``wait_s`` (time blocked acquiring),
    ``hold_s`` (time held). Empty unless ``OE_REPORT_TRACE_LOCKS=1`` (or
    ``EnvConfig.report.trace_locks``) armed the traced locks before the
    instrumented objects were constructed."""
    from ..analysis import concurrency
    return concurrency.lock_stats()


def potential_deadlocks() -> list:
    """Lock-order cycles the traced locks observed (graftrace runtime
    plane): *potential* deadlocks, reported even when the schedule never
    realized them. Empty when tracing is off."""
    from ..analysis import concurrency
    return concurrency.potential_deadlocks()


# --- last-value gauges -------------------------------------------------------

# process-wide gauges (latest value wins, unlike the monotonic
# Accumulator counters): checkpoint chain length / write rate, serving
# swap version — exported on /metrics as prometheus gauges
_GAUGE_LOCK = make_lock("observability.gauges")
_GAUGES: Dict[str, float] = {}


def set_gauge(name: str, value: float) -> None:
    with _GAUGE_LOCK:
        _GAUGES[name] = float(value)


def gauges() -> Dict[str, float]:
    with _GAUGE_LOCK:
        return dict(_GAUGES)


# LABELED last-value gauges: a separate store so the flat ``gauges()``
# view (ckpt_stats/swap_stats consume it) keeps its shape. Keyed
# ``name -> {sorted (label, value) tuple -> value}``; rendered on
# /metrics as ``oe_<name>{label="..."} v`` with one HELP/TYPE per name
# (the per-table pull_unique_ratio_last / pull_key_skew_last gauges)
_LABELED_GAUGE_LOCK = make_lock("observability.labeled_gauges")
_LABELED_GAUGES: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}


def set_labeled_gauge(name: str, value: float, **labels) -> None:
    key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    with _LABELED_GAUGE_LOCK:
        _LABELED_GAUGES.setdefault(str(name), {})[key] = float(value)


def labeled_gauges() -> Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                       float]]:
    with _LABELED_GAUGE_LOCK:
        return {name: dict(series)
                for name, series in _LABELED_GAUGES.items()}


def add_labeled(name: str, value: float = 1.0, **labels) -> None:
    """Labeled monotonic counter in the scope registry: rendered as
    ``oe_<name>_total{label="..."}`` on /metrics, read back with
    ``scope.HISTOGRAMS.counter(name, **labels)`` (the adaptive batch
    tuner's ``plan_adjust{knob=,direction=}`` steps count here)."""
    scope.HISTOGRAMS.inc(name, float(value), **labels)


# --- checkpoint / serving-swap counters (delta checkpoint plane) -------------

def record_ckpt_save(mode: str, nbytes: int, seconds: float, *,
                     chain_len: Optional[int] = None,
                     accumulator: Optional[Accumulator] = None) -> None:
    """One checkpoint save's ledger entry (``checkpoint.save_checkpoint``):
    ``ckpt_full_bytes``/``ckpt_delta_bytes`` counters accumulate bytes
    moved per mode — the delta plane's headline claim (a ≤5%-dirty delta
    moves ≥10x fewer bytes than a full save) is asserted against exactly
    these counters — plus ``ckpt_write_gbps``/``ckpt_chain_len`` gauges
    and a per-mode write-rate histogram for /metrics."""
    acc = accumulator or GLOBAL
    acc.add(f"ckpt_{mode}_bytes", float(nbytes))
    acc.add(f"ckpt_{mode}_saves", 1.0)
    gbps = nbytes / max(seconds, 1e-9) / 1e9
    set_gauge("ckpt_write_gbps", gbps)
    if chain_len is not None:
        set_gauge("ckpt_chain_len", float(chain_len))
    scope.HISTOGRAMS.observe("ckpt_write_gbps", gbps, mode=mode)


def ckpt_stats(accumulator: Optional[Accumulator] = None) -> Dict[str, float]:
    """Checkpoint-plane counters: bytes/saves per mode (monotonic) plus
    the latest chain length and write rate."""
    snap = (accumulator or GLOBAL).snapshot()
    g = gauges()

    def _count(name: str) -> float:
        return snap.get(name, {}).get("count", 0.0)

    return {
        "ckpt_full_bytes": _count("ckpt_full_bytes"),
        "ckpt_delta_bytes": _count("ckpt_delta_bytes"),
        "ckpt_full_saves": _count("ckpt_full_saves"),
        "ckpt_delta_saves": _count("ckpt_delta_saves"),
        "ckpt_chain_len": g.get("ckpt_chain_len", 0.0),
        "ckpt_write_gbps": g.get("ckpt_write_gbps", 0.0),
    }


def record_swap(rows: int, version: int, *,
                accumulator: Optional[Accumulator] = None) -> None:
    """One serving hot-swap (``ModelRegistry.apply_delta``): swap count +
    rows patched (counters) and the published version (gauge)."""
    acc = accumulator or GLOBAL
    acc.add("serving_swap_total", 1.0)
    acc.add("serving_swap_rows", float(rows))
    set_gauge("serving_swap_version", float(version))


def swap_stats(accumulator: Optional[Accumulator] = None) -> Dict[str, float]:
    snap = (accumulator or GLOBAL).snapshot()
    g = gauges()
    return {
        "serving_swap_total": snap.get("serving_swap_total",
                                       {}).get("count", 0.0),
        "serving_swap_rows": snap.get("serving_swap_rows",
                                      {}).get("count", 0.0),
        "serving_swap_version": g.get("serving_swap_version", 0.0),
    }


# --- host-memory ledger (graftwatch) -----------------------------------------

# live memory sources, keyed by object id -> (kind, name, weakref):
# offload tables, hot-cache managers, and the serving registry register
# themselves at construction; dead objects fall out via the weakref
# (pruned lazily at each snapshot), so accounting never extends an
# object's lifetime
_MEM_LOCK = make_lock("observability.memsources")
_MEM_SOURCES: Dict[int, Tuple[str, str, Any]] = {}


def register_memory_source(kind: str, name: str, obj) -> None:
    """Track ``obj`` in the host-memory ledger (``memory_stats``).

    ``obj`` must expose ``memory_stats() -> Dict[str, float]`` of byte/
    count gauges. Registration is weak: the ledger observes, it never
    keeps anything alive.
    """
    ref = weakref.ref(obj)
    with _MEM_LOCK:
        _MEM_SOURCES[id(obj)] = (str(kind), str(name), ref)


def memory_stats() -> Dict[str, Dict[str, float]]:
    """Live host-memory ledger: ``{source: {gauge: value}}``.

    Covers the host RAM the framework holds outside device buffers —
    offload stores + residency books, hot-cache replicas and admission
    sketches, registry-loaded serving models — plus the graftscope span
    rings. Sources are ``"<kind>/<name>"`` keys (duplicate names get a
    ``#n`` suffix); every value is a float gauge, exported as
    ``oe_mem_*`` on the serving ``/metrics`` page.
    """
    out: Dict[str, Dict[str, float]] = {
        "scope/rings": {k: float(v) for k, v in scope.ring_stats().items()}
    }
    with _MEM_LOCK:
        items = list(_MEM_SOURCES.items())
    dead = []
    for key, (kind, name, ref) in items:
        obj = ref()
        if obj is None:
            dead.append(key)
            continue
        try:
            st = obj.memory_stats()
        except Exception:  # noqa: BLE001 — the ledger observes a LIVE
            # system; a source racing its own teardown must read as
            # absent, never crash a /metrics scrape
            continue
        label = f"{kind}/{name}"
        n = 2
        while label in out:
            label = f"{kind}/{name}#{n}"
            n += 1
        out[label] = {str(k): float(v) for k, v in st.items()}
    if dead:
        with _MEM_LOCK:
            for key in dead:
                _MEM_SOURCES.pop(key, None)
    return out


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out.lstrip("0123456789_") or "metric"


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(accumulator: Optional[Accumulator] = None,
                    prefix: str = "oe",
                    include_scope: bool = True,
                    include_mem: bool = True) -> str:
    """Render the accumulator in Prometheus text exposition format.

    The serving controller exposes this at GET /metrics — parity with the
    reference PS daemon's prometheus exposer (entry/server.cc:32-36,
    --enable_metrics/--metrics_url). Counters become ``<prefix>_<name>_total``;
    timers contribute ``_seconds_total`` and ``_calls_total`` pairs. Every
    series carries ``# HELP``/``# TYPE`` headers and label values are
    escaped, so a real Prometheus scraper parses the page (golden-tested
    in ``tests/test_observability.py``). ``include_scope`` appends the
    graftscope histogram registry as proper ``_bucket``/``_sum``/
    ``_count`` series (span latencies, per-table pull distributions);
    ``include_mem`` appends the graftwatch host-memory ledger
    (:func:`memory_stats`) as ``<prefix>_mem_<gauge>{source="..."}``
    gauges — offload stores/books, hot-cache replicas + sketches,
    loaded serving models, span rings.
    """
    acc = accumulator or GLOBAL
    lines = []
    snap = acc.snapshot()
    for name in sorted(snap):
        base = f"{prefix}_{_prom_name(name)}"
        fields = snap[name]
        if "count" in fields:
            lines.append(f"# HELP {base}_total accumulated count of "
                         f"`{name}`")
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total {fields['count']:.10g}")
        if "seconds" in fields:
            lines.append(f"# HELP {base}_seconds_total accumulated "
                         f"wall seconds of `{name}`")
            lines.append(f"# TYPE {base}_seconds_total counter")
            lines.append(f"{base}_seconds_total {fields['seconds']:.10g}")
            lines.append(f"# HELP {base}_calls_total timed calls of "
                         f"`{name}`")
            lines.append(f"# TYPE {base}_calls_total counter")
            lines.append(f"{base}_calls_total {fields['calls']}")
    # last-value gauges (checkpoint chain length / write rate, serving
    # swap version, ...)
    for name, value in sorted(gauges().items()):
        base = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# HELP {base} last-value gauge `{name}`")
        lines.append(f"# TYPE {base} gauge")
        lines.append(f"{base} {value:.10g}")
    # labeled last-value gauges (per-table batch-shape stats): one
    # HELP/TYPE per name, one series per label set
    for name, series in sorted(labeled_gauges().items()):
        base = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# HELP {base} last-value gauge `{name}` "
                     f"(labeled)")
        lines.append(f"# TYPE {base} gauge")
        for key in sorted(series):
            lab = ",".join(
                f'{k}="{_esc_label(v)}"' for k, v in key)
            lines.append(f"{base}{{{lab}}} {series[key]:.10g}")
    # graftrace traced-lock counters (empty unless OE_REPORT_TRACE_LOCKS)
    for name, st in sorted(lock_stats().items()):
        base = f"{prefix}_lock_{_prom_name(name)}"
        for suffix, key, help_txt in (
                ("acquires_total", "acquires", "lock acquisitions"),
                ("contended_total", "contended",
                 "acquisitions that found the lock held"),
                ("wait_seconds_total", "wait_s",
                 "seconds blocked acquiring"),
                ("hold_seconds_total", "hold_s", "seconds held")):
            lines.append(f"# HELP {base}_{suffix} {help_txt} of traced "
                         f"lock `{name}`")
            lines.append(f"# TYPE {base}_{suffix} counter")
            lines.append(f"{base}_{suffix} {st[key]:.10g}")
    if acc is GLOBAL:
        # the step timings and the kernels' key counters are process-wide,
        # as GLOBAL is
        lines.extend(_step_lines(prefix))
        lines.extend(_hash_find_lines(prefix))
    if include_scope:
        lines.extend(scope.HISTOGRAMS.prometheus_lines(prefix))
    if include_mem:
        # graftwatch host-memory ledger: one gauge per (source, field);
        # HELP/TYPE emitted once per gauge name like the series above
        mem = memory_stats()
        by_field: Dict[str, list] = {}
        for source in sorted(mem):
            for field in sorted(mem[source]):
                by_field.setdefault(field, []).append(
                    (source, mem[source][field]))
        for field in sorted(by_field):
            base = f"{prefix}_mem_{_prom_name(field)}"
            lines.append(f"# HELP {base} graftwatch host-memory ledger "
                         f"gauge `{field}` (labeled by source)")
            lines.append(f"# TYPE {base} gauge")
            for source, value in by_field[field]:
                esc = source.replace("\\", "\\\\").replace('"', '\\"')
                lines.append(f'{base}{{source="{esc}"}} {value:.10g}')
    return "\n".join(lines) + ("\n" if lines else "")


class Reporter:
    """Rank-0 periodic metrics printer (WorkerContext reporter thread).

    ``report_interval`` seconds between dumps; 0 disables (the reference's
    server.report_interval default semantics). Thread discipline matches
    the other host daemons (graftrace coverage): the shared tick counter
    is guarded by a ``make_lock`` lock, the loop carries ``sync_point``
    markers so the deterministic interleaving harness can park it, the
    thread is named ``oe-reporter``, and ``stop()`` joins it."""

    def __init__(self, interval: float,
                 accumulator: Optional[Accumulator] = None,
                 sink: Callable[[str], None] = print):
        self.interval = interval
        self.acc = accumulator or GLOBAL
        self.sink = sink
        self._lock = make_lock("observability.reporter")
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Reporter":
        if self.interval and self.interval > 0:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="oe-reporter")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            sync_point("reporter.tick")
            self.report()
        sync_point("reporter.exit")

    @property
    def ticks(self) -> int:
        """Reports emitted so far (reporter thread + direct calls)."""
        with self._lock:
            return self._ticks

    def report(self):
        snap = self.acc.snapshot()
        with self._lock:
            self._ticks += 1
        parts = []
        for name in sorted(snap):
            fields = ", ".join(f"{k}={v:.6g}"
                               for k, v in sorted(snap[name].items()))
            parts.append(f"{name}[{fields}]")
        if self.acc is GLOBAL:
            parts.extend(_step_report())
        if parts:
            self.sink("metrics: " + " ".join(parts))

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class StreamingAUC:
    """Fixed-bin streaming AUC — device-friendly histogram method.

    The reference reports AUC through keras metrics; here scores are binned
    into ``bins`` buckets per update and AUC is computed from the positive /
    negative histograms (exact up to bin resolution, O(1) memory for
    arbitrarily long evaluation streams).
    """

    def __init__(self, bins: int = 8192):
        self.bins = bins
        self.pos = np.zeros(bins, np.int64)
        self.neg = np.zeros(bins, np.int64)

    def update(self, labels, scores) -> None:
        labels = np.asarray(labels).ravel()
        scores = np.clip(np.asarray(scores, np.float64).ravel(), 0.0, 1.0)
        idx = np.minimum((scores * self.bins).astype(np.int64), self.bins - 1)
        self.pos += np.bincount(idx[labels > 0.5], minlength=self.bins)
        self.neg += np.bincount(idx[labels <= 0.5], minlength=self.bins)

    def result(self) -> float:
        """P(score_pos > score_neg) + 0.5 P(tie), from the histograms."""
        total_pos = self.pos.sum()
        total_neg = self.neg.sum()
        if total_pos == 0 or total_neg == 0:
            return 0.5
        neg_below = np.concatenate([[0], np.cumsum(self.neg)[:-1]])
        wins = float(np.sum(self.pos * neg_below))
        ties = float(np.sum(self.pos * self.neg))
        return (wins + 0.5 * ties) / (float(total_pos) * float(total_neg))
