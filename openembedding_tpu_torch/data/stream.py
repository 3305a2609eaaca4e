"""Parallel streaming ingest (``openembedding_tpu/data/stream.py``): a
multi-shard reader pool and a bounded prefetch ring.

The reference system's headline number is an ingest number: raw
Criteo-1TB TSV hashed on the fly at the step's rate. The single-file
readers (``criteo.read_criteo_tsv``, ``tfrecord.read_criteo_tfrecord``)
parse on the caller's critical path; this module keeps the step loop fed
from on-disk shards.

**Architecture** — :class:`ShardStream`:

* a READER POOL: ``readers`` threads, shard ``i`` of the sorted shard list
  assigned to reader ``i % readers`` (the tf.data ``interleave`` layout).
  Each reader streams its shards in order, parses rows (TSV field split
  and hex-categorical decode, or the TFRecord CRC-verified protobuf walk)
  and builds batches: parse, ``mix64`` hashing and the ``log1p`` squash
  all run on the worker, off the step loop's critical path.
* a BOUNDED, MEMORY-LEDGERED RING: each reader owns a bounded output
  queue (``ring_batches`` in all); the consumer pops round-robin across
  readers in a fixed order, so the batch sequence is a DETERMINISTIC
  function of (shard list, readers, batch_size): thread timing can
  reorder work, never output. The ring is an ``observability.
  memory_stats`` source (``ingest/<name>``).
* IDENTITY-STABLE batches: every batch dict is built once, on the worker,
  and yielded once; per-batch rewrites (``FusedMapper.fuse_batch``) go
  through ``transform=``, on the worker.
* STALL ACCOUNTING: a pop that finds data ready records a stall of
  exactly ``0.0``; a pop that blocks records its wait as an
  ``ingest.ring`` span plus the ``ingest_stall_ms`` histogram and the
  ``ingest_stall`` timer (``observability.record_ingest_stall``).
  :meth:`stall_stats` returns the per-pop series, so "the step never
  blocked on data after warm-up" is checkable as ``p95 == 0.0`` exactly.
  The stream marks itself ``ingest_accounted``: ``Trainer.fit`` does not
  count the same wait twice.
* LOUD FAILURE: a reader thread that dies (CRC mismatch, truncated
  TFRecord, I/O error) fails the NEXT pop with a RuntimeError naming the
  reader and shard, never a hang (every wait is bounded by
  ``_WAIT_QUANTUM_S`` and re-checks the readers) and never a silently
  short epoch. Unparseable TSV ROWS, by contrast, are skipped and counted
  (``criteo.note_bad_rows``): row damage is survivable, container damage
  is not.

**Synthetic shard source** — :func:`write_synthetic_shards` writes real
TSV/TFRecord shard files with Criteo-1TB-shaped content (zipf key
marginals per feature, hex-string categoricals, poisson counts), so the
ingest path runs where the real data set does not live; shards are
written locally, never downloaded. Spans: ``ingest.read`` (shard I/O and
row parse), ``ingest.hash`` (hash, squash, transform), ``ingest.ring``
(consumer waits).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..analysis import scope
from ..analysis.concurrency import sync_point
from ..utils import observability
from . import criteo, tfrecord

# default pool shape: two readers keep parse off the critical path
# without oversubscribing small hosts; eight buffered batches absorb a
# step-time's worth of jitter at the measured parse/step ratios
DEFAULT_READERS = 2
DEFAULT_RING_BATCHES = 8

# bounded wait quantum for every ring wait (producer AND consumer): a
# dead peer that never notifies costs at most one quantum before the
# liveness re-check sees it — the "a dead reader must never hang the
# ring" contract is this number, not a prayer
_WAIT_QUANTUM_S = 0.25

# bounded stall history: enough for any bench window at 8 bytes/step
# without growing forever on a month-long run
_STALL_CAPACITY = 1 << 16


class _Stopped(Exception):
    """Internal reader unwind on close() — a clean exit, not an error."""


def discover_shards(path, fmt: str = "tsv") -> List[str]:
    """Resolve ``path`` to a sorted shard list: a directory scans for
    ``*.tsv``/``shard-*`` (tsv) or ``tf-part.*`` (tfrecord, the
    reference's sharded layout), a file is itself the single shard, a
    sequence passes through in the given order."""
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    path = str(path)
    if not os.path.isdir(path):
        return [path]
    if fmt == "tfrecord":
        names = [f for f in os.listdir(path) if f.startswith("tf-part.")]
    else:
        names = [f for f in os.listdir(path)
                 if f.endswith(".tsv") or f.startswith("shard-")]
    if not names:
        raise FileNotFoundError(
            f"no {fmt} shards under {path} (tsv: *.tsv / shard-*; "
            "tfrecord: tf-part.*)")
    return [os.path.join(path, f) for f in sorted(names)]


class ShardStream:
    """Iterator of training batch dicts from on-disk shards (see module
    docstring for the architecture). ``epochs=None`` streams the shard
    list forever (bench/endurance lanes); finite epochs end with
    StopIteration once every reader drains. Batches never mix rows
    across readers (reader-local batching keeps the output order
    deterministic); with ``drop_remainder`` each reader drops its final
    partial batch. Always ``close()`` (or use as a context manager) when
    abandoning the stream early — readers parked on a full ring are
    daemon threads, but an un-closed stream keeps their buffers alive.
    """

    # Trainer.fit protocol: this iterator records its own per-pop
    # ingest_stall_ms accounting, so the fit loop must not count its
    # next() wall time into the same series again
    ingest_accounted = True

    def __init__(self, shards, *, batch_size: int, fmt: str = "tsv",
                 num_buckets: int = 1 << 25,
                 readers: Optional[int] = None,
                 ring_batches: int = DEFAULT_RING_BATCHES,
                 epochs: Optional[int] = 1,
                 drop_remainder: bool = True,
                 add_linear: bool = False,
                 transform: Optional[Callable[[Dict], Dict]] = None,
                 verify: bool = True,
                 name: str = "stream"):
        if fmt not in ("tsv", "tfrecord"):
            raise ValueError(f"fmt must be 'tsv' or 'tfrecord', got {fmt!r}")
        if epochs is not None and epochs < 1:
            raise ValueError(f"epochs must be >= 1 or None, got {epochs}")
        self.paths = discover_shards(shards, fmt)
        self.fmt = fmt
        self.batch_size = int(batch_size)
        self.num_buckets = int(num_buckets)
        self.epochs = epochs
        self.drop_remainder = bool(drop_remainder)
        self.add_linear = bool(add_linear)
        self.transform = transform
        self.verify = bool(verify)
        self.name = str(name)
        if readers is None:
            # a planner-emitted EnvConfig (or OE_PLAN_READERS) widens
            # the pool; an explicit ``readers=`` argument always wins
            from ..utils.envconfig import EnvConfig
            readers = EnvConfig.load().plan.readers or DEFAULT_READERS
        self.readers = max(1, min(int(readers), len(self.paths)))
        per_reader = max(1, int(ring_batches) // self.readers)
        self.ring_batches = per_reader * self.readers
        # ONE condition guards every shared field below: queues, done
        # flags, errors, stop flag, row counters, stalls
        self._cv = threading.Condition()
        self._queues: List[deque] = [deque() for _ in range(self.readers)]
        self._per_reader = per_reader
        self._done = [False] * self.readers
        self._errors: List[tuple] = []       # (reader id, shard, exc)
        self._stop = False
        self._rows = 0
        self._bad = 0
        self._emitted = 0
        self._warned: list = []
        self._stalls: deque = deque(maxlen=_STALL_CAPACITY)
        # consumer rotation: fixed reader order, finished readers
        # removed at the deterministic point their queue drains
        self._order = list(range(self.readers))
        self._rr = 0
        self._consumed = 0
        self._raised: Optional[BaseException] = None
        # ring memory ledger source (oe_mem_*{source="ingest/<name>"})
        observability.register_memory_source("ingest", self.name, self)
        # daemon + joined by close(): an abandoned stream must not block
        # interpreter exit, a closed one leaves no thread behind
        self._threads: List[threading.Thread] = []
        for rid in range(self.readers):
            t = threading.Thread(target=self._reader, args=(rid,),
                                 daemon=True, name=f"oe-ingest-{rid}")
            self._threads.append(t)
            t.start()

    # --- reader side -------------------------------------------------------
    def _rows_tsv(self, path: str) -> Iterator[tuple]:
        """Parsed rows of one TSV shard; bad rows skipped + counted."""
        with open(path, "r") as f:
            while True:
                with scope.span("ingest.read", stream=self.name,
                                fmt="tsv", detail={"shard": path}):
                    lines = f.readlines(1 << 20)
                    good = []
                    n_bad = 0
                    for line in lines:
                        row = criteo.parse_tsv_row(line)
                        if row is None:
                            n_bad += 1
                        else:
                            good.append(row)
                if not lines:
                    return
                if n_bad:
                    with self._cv:
                        self._bad += n_bad
                        self._rows += len(lines)
                        bad, total = self._bad, self._rows
                        criteo.note_bad_rows(n_bad, bad, total, path,
                                             self._warned)
                else:
                    with self._cv:
                        self._rows += len(lines)
                yield from good

    def _rows_tfrecord(self, path: str) -> Iterator[tuple]:
        """Parsed rows of one TFRecord shard (RAW Criteo layout: label
        int64, I1..I13 raw counts, C1..C26 raw int64 ids — the
        :func:`write_synthetic_shards` format; hashing happens at emit).
        Container damage (CRC mismatch, truncation) raises — a torn
        record means every later record is suspect, unlike a mangled
        TSV line."""
        for rec in tfrecord.read_records(path, verify=self.verify):
            with scope.span("ingest.read", stream=self.name,
                            fmt="tfrecord", detail={"shard": path}):
                ex = tfrecord.parse_example(rec)
                label = float(ex.get("label", [0])[0])
                dense = [float(ex.get(f"I{i}", [0.0])[0] or 0.0)
                         for i in range(1, criteo.NUM_DENSE + 1)]
                sparse = [int(ex.get(n, [0])[0])
                          for n in criteo.SPARSE_NAMES]
            with self._cv:
                self._rows += 1
            yield label, dense, sparse

    def _emit(self, labels: list, dense: list, sparse: list) -> Dict:
        """Row lists -> one batch dict: mix64 hash + log1p squash (the
        ``to_hash_bucket_fast`` role), optional ':linear' twins and the
        caller transform — all on the worker thread."""
        with scope.span("ingest.hash", stream=self.name):
            batch = criteo._emit(labels, dense, sparse, self.num_buckets)
            if self.add_linear:
                sp = dict(batch["sparse"])
                for n in list(sp):
                    sp[n + ":linear"] = sp[n]
                batch = {**batch, "sparse": sp}
            if self.transform is not None:
                batch = self.transform(batch)
        return batch

    def _put(self, rid: int, batch: Dict) -> None:
        """Blocking bounded-ring append (producer side)."""
        with self._cv:
            while len(self._queues[rid]) >= self._per_reader:
                if self._stop:
                    raise _Stopped
                self._cv.wait(_WAIT_QUANTUM_S)
            if self._stop:
                raise _Stopped
            sync_point("ingest.ring.put")
            self._queues[rid].append(batch)
            self._emitted += 1
            self._cv.notify_all()

    def _reader(self, rid: int) -> None:
        shard = ""
        try:
            labels: list = []
            dense: list = []
            sparse: list = []
            epoch = 0
            while self.epochs is None or epoch < self.epochs:
                for shard in self.paths[rid::self.readers]:
                    rows = (self._rows_tsv(shard) if self.fmt == "tsv"
                            else self._rows_tfrecord(shard))
                    for label, d, s in rows:
                        labels.append(label)
                        dense.append(d)
                        sparse.append(s)
                        if len(labels) == self.batch_size:
                            self._put(rid, self._emit(labels, dense,
                                                      sparse))
                            labels, dense, sparse = [], [], []
                    with self._cv:
                        if self._stop:
                            raise _Stopped
                epoch += 1
            if labels and not self.drop_remainder:
                self._put(rid, self._emit(labels, dense, sparse))
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised at pop
            with self._cv:
                self._errors.append((rid, shard, e))
        finally:
            with self._cv:
                self._done[rid] = True
                self._cv.notify_all()

    # --- consumer side -----------------------------------------------------
    def __iter__(self) -> "ShardStream":
        return self

    def __next__(self) -> Dict:
        stall = 0.0
        t_wait = None
        with self._cv:
            if self._raised is not None:
                # a failed stream stays failed: re-raise, never resume
                raise RuntimeError(
                    "shard stream already failed") from self._raised
            while True:
                if self._errors:
                    rid, shard, err = self._errors[0]
                    self._raised = err
                    raise RuntimeError(
                        f"shard reader {rid} of stream "
                        f"{self.name!r} failed on {shard!r}: "
                        f"{type(err).__name__}: {err} — epoch aborted "
                        "(a dead reader must fail loudly, never hang "
                        "the ring)") from err
                if self._stop:
                    raise StopIteration
                # drop finished-and-drained readers from the rotation
                # (deterministic: governed by data, not thread timing)
                while self._order:
                    pos = self._rr % len(self._order)
                    cur = self._order[pos]
                    if self._done[cur] and not self._queues[cur]:
                        self._order.pop(pos)
                        self._rr = pos  # successor slides into place
                    else:
                        self._rr = pos
                        break
                if not self._order:
                    raise StopIteration
                q = self._queues[cur]
                if q:
                    sync_point("ingest.ring.pop")
                    batch = q.popleft()
                    self._rr = (self._rr + 1) % len(self._order)
                    self._consumed += 1
                    self._cv.notify_all()
                    self._note_stall_locked(stall, t_wait)
                    return batch
                # the round-robin target's queue is empty: WAIT on that
                # reader specifically (order stays deterministic); the
                # wait is the stall the accounting exists to expose
                if t_wait is None:
                    t_wait = time.perf_counter()
                self._cv.wait(_WAIT_QUANTUM_S)
                stall = time.perf_counter() - t_wait

    def _note_stall_locked(self, stall_s: float,
                           t_wait: Optional[float] = None) -> None:
        """Record one pop's stall (caller holds ``_cv``). Pops that
        never waited record exactly 0.0 — the "p95 == 0" claim is over
        these exact zeros, not histogram-bucket approximations."""
        self._stalls.append(stall_s * 1e3)
        observability.record_ingest_stall(stall_s, stream=self.name)
        if stall_s > 0.0 and t_wait is not None:
            scope.record_span("ingest.ring", t_wait, stall_s,
                              {"stream": self.name})

    # --- resume positioning ------------------------------------------------
    def cursor(self) -> int:
        """Batches consumed so far. Because the batch sequence is a
        deterministic function of (shard list, readers, batch_size),
        this integer IS the stream position: a fresh stream built with
        the same arguments and advanced by :meth:`skip_batches` to the
        same cursor yields the identical remaining sequence. The
        Trainer's autosave records this value in the checkpoint
        manifest so an elastic resume restarts ingest exactly where the
        committed step left it."""
        with self._cv:
            return self._consumed

    def skip_batches(self, n: int) -> int:
        """Advance the stream by exactly ``n`` batches and return the
        new cursor. Skipped batches are produced and discarded — rows
        are still parsed, so a resume pays O(cursor) skip work — but
        positioning is EXACT: the next ``next()`` yields the same batch
        the original stream would have yielded at that cursor. Raises
        ValueError if the stream ends before ``n`` batches (a cursor
        past the data means the manifest and shard set disagree)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"skip_batches: n must be >= 0, got {n}")
        for i in range(n):
            try:
                next(self)
            except StopIteration:
                raise ValueError(
                    f"skip_batches({n}): stream exhausted after {i} "
                    "batches — resume cursor is past the shard set "
                    "(wrong shards, epochs, or batch_size?)") from None
        return self.cursor()

    # --- accounting --------------------------------------------------------
    def stall_stats(self) -> np.ndarray:
        """Per-pop stall series (ms) since construction or the last
        :meth:`reset_stall_stats` — one entry per batch consumed."""
        with self._cv:
            return np.asarray(self._stalls, np.float64)

    def reset_stall_stats(self) -> None:
        """Drop recorded stalls (bench: call at the warmup boundary so
        the measured window excludes ring-fill waits)."""
        with self._cv:
            self._stalls.clear()

    def stall_summary(self) -> Dict[str, float]:
        """``{pops, stalled, p50_ms, p95_ms, p99_ms, max_ms}`` over the
        recorded stall series (zeros for an empty series)."""
        s = self.stall_stats()
        if not s.size:
            return {"pops": 0, "stalled": 0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        return {"pops": int(s.size), "stalled": int((s > 0.0).sum()),
                "p50_ms": float(np.percentile(s, 50)),
                "p95_ms": float(np.percentile(s, 95)),
                "p99_ms": float(np.percentile(s, 99)),
                "max_ms": float(s.max())}

    def bad_rows(self) -> int:
        with self._cv:
            return self._bad

    def memory_stats(self) -> Dict[str, float]:
        """Ring ledger gauges (``observability.memory_stats`` source):
        buffered batches/bytes against the bound, rows read, bad rows,
        live readers. The bound is what makes a streaming epoch O(ring)
        in host memory no matter how large the shard set is."""
        with self._cv:
            buffered = [b for q in self._queues for b in q]
            alive = sum(1 for d in self._done if not d)
            rows, bad, emitted = self._rows, self._bad, self._emitted
            consumed = self._consumed
        nbytes = 0
        for b in buffered:
            for leaf in list(b.values()):
                if isinstance(leaf, dict):
                    nbytes += sum(v.nbytes for v in leaf.values()
                                  if hasattr(v, "nbytes"))
                elif hasattr(leaf, "nbytes"):
                    nbytes += leaf.nbytes
        return {"ring_batches": float(len(buffered)),
                "ring_capacity_batches": float(self.ring_batches),
                "ring_bytes": float(nbytes),
                "rows_read": float(rows),
                "bad_rows": float(bad),
                "batches_emitted": float(emitted),
                "batches_consumed": float(consumed),
                "readers_alive": float(alive)}

    # --- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the readers and join them (idempotent). Buffered batches
        are dropped; a later ``next()`` raises StopIteration."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)

    def __enter__(self) -> "ShardStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- synthetic sharded source ------------------------------------------------

def write_synthetic_shards(out_dir: str, *, num_shards: int = 8,
                           rows_per_shard: int = 8192, fmt: str = "tsv",
                           seed: int = 0, zipf_a: float = 1.2,
                           bad_rows_per_shard: int = 0) -> List[str]:
    """Write Criteo-1TB-distribution-faithful synthetic shard files.

    Content matches what the raw 1TB TSV looks like where it matters to
    the ingest path: per-feature ZIPF key marginals (real click logs
    are heavy-tailed; uniform ids overestimate dedup wins — the
    ``synthetic_criteo`` rationale), columns decorated so features
    don't share id streams, HEX-STRING categoricals (the parse cost
    under test), poisson count features, ~25% positive labels.
    Deterministic per (seed, shard index), so shard sets regenerate
    identically anywhere.

    ``fmt="tsv"`` writes ``shard-NNNNN.tsv`` raw-TSV shards;
    ``fmt="tfrecord"`` writes ``tf-part.NNNNN`` CRC-framed files with
    the RAW layout (label/C* int64, I* float) that
    :class:`ShardStream` hashes on the fly. ``bad_rows_per_shard``
    injects mangled TSV lines (test hook for the bad-row lane).
    Returns the shard paths in order.
    """
    if fmt not in ("tsv", "tfrecord"):
        raise ValueError(f"fmt must be 'tsv' or 'tfrecord', got {fmt!r}")
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    for s in range(num_shards):
        rng = np.random.RandomState(seed * 100_003 + s)
        n = int(rows_per_shard)
        label = (rng.rand(n) > 0.75).astype(np.int64)
        dense = rng.poisson(3.0, size=(n, criteo.NUM_DENSE))
        raw = rng.zipf(zipf_a, size=(n, criteo.NUM_SPARSE)).astype(
            np.int64)
        # decorate per-feature so columns don't share id streams (the
        # synthetic_criteo convention; the reader's +1 offset and mix64
        # hash land these in the same marginals the in-memory synthetic
        # stream produces)
        ids = raw * (np.arange(criteo.NUM_SPARSE, dtype=np.int64) + 1)
        if fmt == "tsv":
            path = os.path.join(out_dir, f"shard-{s:05d}.tsv")
            bad_at = set()
            if bad_rows_per_shard:
                bad_at = set(rng.choice(n, size=min(bad_rows_per_shard,
                                                    n), replace=False))
            with open(path, "w") as f:
                for i in range(n):
                    if i in bad_at:
                        # two flavors of real-world damage: a truncated
                        # line and a non-hex categorical
                        f.write("1\t5\n" if i % 2 else
                                "\t".join(["1"]
                                          + ["3"] * criteo.NUM_DENSE
                                          + ["zz-not-hex"]
                                          * criteo.NUM_SPARSE) + "\n")
                        continue
                    f.write("\t".join(
                        [str(int(label[i]))]
                        + [str(int(v)) for v in dense[i]]
                        + ["%x" % int(v) for v in ids[i]]) + "\n")
        else:
            path = os.path.join(out_dir, f"tf-part.{s:05d}")
            with open(path, "wb") as f:
                for i in range(n):
                    feats: Dict[str, list] = {
                        "label": [int(label[i])]}
                    for j in range(criteo.NUM_DENSE):
                        feats[f"I{j + 1}"] = [float(dense[i, j])]
                    for j, cname in enumerate(criteo.SPARSE_NAMES):
                        feats[cname] = [int(ids[i, j])]
                    tfrecord.write_record(f, tfrecord.make_example(feats))
        paths.append(path)
    return paths
