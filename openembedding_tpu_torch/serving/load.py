"""Open-loop serving load (the port's copy of ``tools/graftload.py``'s
storm core, which imports the JAX package).

Arrivals are a Poisson process at the OFFERED rate
(:func:`poisson_arrivals`, the same arrivals as graftload's from the
same seed), and every request's latency is measured from its INTENDED
send time, not from when a worker got to it: a closed-loop load slows
its own clock when the server stalls and reports a flat p99 exactly when
it matters (coordinated omission). Here a backlog shows up as latency.
The worker pool bounds concurrency, not the accounting; each send's
lateness against its intended time is kept, since a sender that falls
behind measures the client, not the server.

:func:`run_storm` drives one rate, :func:`find_knee` picks the highest
sustained one, :func:`make_rest_sender` sends ``lookup_bin`` requests of
seeded uniform ids through a ``ha.RoutingClient``, and
:func:`scrape_batch_stats` sums the replicas' batcher counters off
``/metrics``. A 429 from every replica raises :class:`RejectedError` in
the sender, counted apart from errors.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..analysis import scope


class RejectedError(Exception):
    """The request was REJECTED by batcher backpressure (HTTP 429 from
    every replica): counted separately from errors — an oversubscribed
    offer is SUPPOSED to degrade to rejections, never to failures on
    accepted requests."""


# --- open-loop scheduling ----------------------------------------------------

def poisson_arrivals(rate: float, duration: float,
                     seed: int = 0) -> np.ndarray:
    """Intended send times (seconds from storm start) of a Poisson
    arrival process at ``rate``/s over ``duration`` s: i.i.d.
    exponential gaps, so bursts and lulls occur like real traffic
    instead of a metronome that never tests queueing."""
    if rate <= 0 or duration <= 0:
        return np.zeros((0,), np.float64)
    rng = np.random.RandomState(seed)
    out: List[np.ndarray] = []
    t = 0.0
    while t < duration:
        gaps = rng.exponential(1.0 / rate,
                               size=max(64, int(rate * duration * 0.5)))
        ts = t + np.cumsum(gaps)
        out.append(ts)
        t = float(ts[-1])
    arrivals = np.concatenate(out)
    return arrivals[arrivals < duration]


class StormResult:
    """One storm's coordinated-omission-free accounting."""

    def __init__(self, route: str, offered_qps: float, duration: float,
                 latencies_ms: np.ndarray, arrival_s: np.ndarray,
                 errors: int, rejected: int = 0,
                 lateness_ms: Optional[np.ndarray] = None):
        self.route = route
        self.offered_qps = float(offered_qps)
        self.duration = float(duration)
        self.latencies_ms = np.asarray(latencies_ms, np.float64)
        self.arrival_s = np.asarray(arrival_s, np.float64)
        self.errors = int(errors)
        # 429-busy rejections (batcher backpressure): not completions,
        # not errors — the bounded queue doing its job under an offer
        # past capacity
        self.rejected = int(rejected)
        # how late each send began against its intended time: a sender
        # that falls behind measures the client, not the server
        self.lateness_ms = np.asarray(
            [] if lateness_ms is None else lateness_ms, np.float64)

    @property
    def calls(self) -> int:
        return int(self.latencies_ms.size) + self.errors + self.rejected

    @property
    def achieved_qps(self) -> float:
        """Completed-ok requests over the OFFERED window. When the
        server cannot keep up, completions spill past the window and
        this honestly under-reports the offered rate — the knee
        detector keys off exactly that."""
        n = self.latencies_ms.size
        if not n:
            return 0.0
        # wall time from storm start to last completion, floored at the
        # offered window (a fast server must not report > offered)
        wall = max(self.duration,
                   float((self.arrival_s + self.latencies_ms / 1e3).max()))
        return n / wall

    @property
    def error_rate(self) -> float:
        return self.errors / max(1, self.calls)

    def quantile_ms(self, q: float) -> float:
        if not self.latencies_ms.size:
            return float("nan")
        return float(np.percentile(self.latencies_ms, q * 100.0))

    def per_chunk_qps(self, chunks: int = 4) -> Tuple[float, float]:
        """(min, max) achieved QPS over ``chunks`` equal slices of the
        offered window — the noise band the regression gate widens by."""
        if not self.latencies_ms.size:
            return 0.0, 0.0
        done = self.arrival_s + self.latencies_ms / 1e3
        edges = np.linspace(0.0, max(self.duration, float(done.max())),
                            chunks + 1)
        counts, _ = np.histogram(done, bins=edges)
        width = edges[1] - edges[0]
        qps = counts / max(width, 1e-9)
        return float(qps.min()), float(qps.max())

    def lateness_quantile_ms(self, q: float) -> float:
        if not self.lateness_ms.size:
            return float("nan")
        return float(np.percentile(self.lateness_ms, q * 100.0))

    def summary(self) -> Dict[str, Any]:
        """The storm's figures, unrounded: offered and achieved QPS,
        calls, errors, rejections, latency p50/p95/p99 and the senders'
        lateness p50/p99/max."""
        return {"route": self.route,
                "offered_qps": self.offered_qps,
                "achieved_qps": self.achieved_qps,
                "calls": self.calls, "errors": self.errors,
                "rejected": self.rejected,
                "error_rate": self.error_rate,
                "p50_ms": self.quantile_ms(0.50),
                "p95_ms": self.quantile_ms(0.95),
                "p99_ms": self.quantile_ms(0.99),
                "late_p50_ms": self.lateness_quantile_ms(0.50),
                "late_p99_ms": self.lateness_quantile_ms(0.99),
                "late_max_ms": float(self.lateness_ms.max())
                if self.lateness_ms.size else float("nan")}


def run_storm(send: Callable[[int], None], arrivals: np.ndarray, *,
              route: str, offered_qps: float, duration: float,
              workers: int = 16) -> StormResult:
    """Fire ``send(i)`` at each intended arrival time from a worker
    pool; latency is completion minus INTENDED time (see module
    docstring). ``send`` raises on error; errors are counted, their
    latency excluded (an error is not a service time)."""
    workers = max(1, min(int(workers), max(1, arrivals.size)))
    lock = threading.Lock()
    state = {"next": 0, "errors": 0, "rejected": 0}
    lat: List[float] = []
    arr: List[float] = []
    late: List[float] = []
    err_first: List[BaseException] = []
    # small lead-in so worker startup cannot eat the first arrivals
    t0 = time.perf_counter() + 0.05

    def worker():
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if i >= arrivals.size:
                return
            target = t0 + arrivals[i]
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            started = time.perf_counter()
            with lock:
                late.append((started - target) * 1e3)
            try:
                send(i)
            except RejectedError:
                # 429 backpressure: a rejection is a DEFINED response,
                # not a failure — tallied apart from errors so the
                # never-error chaos invariant stays meaningful
                with lock:
                    state["rejected"] += 1
                continue
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                with lock:
                    state["errors"] += 1
                    if not err_first:
                        err_first.append(e)
                continue
            done = time.perf_counter()
            with lock:
                lat.append((done - target) * 1e3)
                arr.append(float(arrivals[i]))

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"oe-load-{k}")
               for k in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = StormResult(route, offered_qps, duration,
                      np.asarray(lat), np.asarray(arr), state["errors"],
                      state["rejected"], np.asarray(late))
    if err_first:
        res.first_error = repr(err_first[0])  # type: ignore[attr-defined]
    return res


def find_knee(results: List[StormResult], *, sustain: float = 0.9
              ) -> Optional[StormResult]:
    """Highest offered rate the cluster SUSTAINED: achieved/offered >=
    ``sustain`` with zero errors. None when even the lowest rate
    saturated."""
    ok = [r for r in results
          if r.errors == 0 and r.achieved_qps >= sustain * r.offered_qps]
    return max(ok, key=lambda r: r.offered_qps) if ok else None


# --- request senders ---------------------------------------------------------

def make_rest_sender(router, sign: str, variable: str, vocab: int,
                     batch: int, seed: int = 1) -> Callable[[int], None]:
    """Per-request REST lookup through the routing client: fresh random
    ids per request (pre-drawn — the storm loop must not pay RNG time),
    each under its own trace id so the Perfetto story is per-request."""
    import urllib.error
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, vocab, size=(256, batch)).astype(np.int32)

    def send(i: int) -> None:
        ids = pool[i % pool.shape[0]]
        try:
            with scope.trace_context():
                rows = router.lookup(sign, variable, ids)
        except urllib.error.HTTPError as e:
            if e.code == 429:
                # every replica's bounded batcher queue was full: the
                # request was REJECTED, by design — not a failure
                raise RejectedError(str(e)) from e
            raise
        if rows.shape[0] != batch:
            raise RuntimeError(f"short read: {rows.shape}")

    return send


def scrape_batch_stats(endpoints) -> Dict[str, float]:
    """Sum the replicas' ``oe_batch_*`` / ``oe_serving_rejected_*``
    counters off /metrics — the server-side coalescing evidence a
    --batched storm reports (flushes vs requests = the batching
    factor). Dead replicas (chaos kills) contribute nothing."""
    import re as re_mod
    import urllib.request
    want = ("oe_batch_flushes_total", "oe_batch_requests_total",
            "oe_batch_rows_total", "oe_batch_unique_rows_total",
            "oe_serving_rejected_total")
    out: Dict[str, float] = {}
    for ep in endpoints:
        try:
            with urllib.request.urlopen(f"http://{ep}/metrics",
                                        timeout=3) as r:
                body = r.read().decode()
        except Exception:  # noqa: BLE001 — a killed replica is expected
            continue
        for name in want:
            m = re_mod.search(rf"^{name} ([0-9.e+]+)$", body,
                              re_mod.MULTILINE)
            if m:
                key = name[len("oe_"):-len("_total")] \
                    if name.endswith("_total") else name[len("oe_"):]
                out[key] = out.get(key, 0.0) + float(m.group(1))
    return out
