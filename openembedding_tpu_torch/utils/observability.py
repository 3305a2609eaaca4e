"""Observability: scoped timers, counters, gauges, the Prometheus page,
the periodic reporter and a streaming AUC (the port's copy of
``openembedding_tpu/utils/observability.py``).

``Accumulator`` counters and ``vtimer`` timers are process-local host
counters; the last-value gauges (checkpoint chain length and write rate,
the serving hot-swap version) and labeled gauges sit beside them;
``record_ckpt_save`` and ``record_swap`` feed the delta checkpoint and
hot-swap ledgers; ``prometheus_text`` renders everything (with the span
histograms of ``analysis/scope.py`` and the host-memory ledger) in the
text exposition format, line for line the JAX package's. Host timings
and host reads mean nothing inside a CUDA graph capture, where the
code runs once per capture: ``under_trace`` reports a capture as JAX's
reports a trace. The exchange planes' ``plane_timed``/``plane_timings``
and the hot-row cache's ``cache_stats`` come with their planes (ROADMAP
Queue 1, multi-shard exchange planes).
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


def record_batch_stats(sparse: Dict[str, np.ndarray],
                       accumulator: Optional[Accumulator] = None) -> None:
    """Per-table batch-shape stats for one batch (host-side).

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
        arr = np.asarray(idx).ravel()
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


def under_trace(tree=None) -> bool:
    """True while the current CUDA stream captures a graph: host-side
    timers and counters must not record there (the host code runs once
    per capture, not once per replay). ``tree`` is accepted for the JAX
    signature; a capture, not the arguments, decides."""
    del tree
    return not scope._trace_state_clean()


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
        if snap:
            parts = []
            for name in sorted(snap):
                fields = ", ".join(f"{k}={v:.6g}"
                                   for k, v in sorted(snap[name].items()))
                parts.append(f"{name}[{fields}]")
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
