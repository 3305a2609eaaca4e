"""Criteo data path (``openembedding_tpu/data/criteo.py``): feature names,
the raw TSV and preprocessed CSV readers, host-side hashing, the
deterministic synthetic stream and ``prefetch``.

* ``read_criteo_tsv`` — streams the raw TSV (label, 13 ints, 26 hex-string
  categoricals); categoricals are parsed as hex ints and avalanche-mixed
  into a bounded bucket space (``mix64``), counts get the log1p squash.
  Unparseable rows are skipped and counted (``note_bad_rows``).
* ``read_criteo_csv`` — the preprocessed numeric csv (``data/preprocess``
  output: label, I1..I13 scaled, C1..C26 label-encoded).
* ``synthetic_criteo`` — reproduces the JAX package's generator draw for
  draw (same ``numpy.random.RandomState`` sequence, same splitmix64
  bucket hash), so a seed gives both packages the same batches.
* ``prefetch`` — keeps ``depth`` placed batches in flight. With
  ``place_fn=Trainer.place_batch`` each batch goes to fresh device
  tensors with copies that do not wait; the captured step copies it into
  its static buffers when it runs, so a batch placed ahead never writes
  into buffers a replay reads.

The parallel shard-pool path is ``data/stream.ShardStream``; the readers
here are its single-file reference (same row semantics, same bad-row
accounting).
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26
DENSE_NAMES = tuple(f"I{i}" for i in range(1, NUM_DENSE + 1))
SPARSE_NAMES = tuple(f"C{i}" for i in range(1, NUM_SPARSE + 1))

# bad-row tolerance of the TSV path: rows that cannot be parsed (short/
# long field count, non-hex categorical, non-numeric count) are SKIPPED
# and counted (`ingest_bad_rows`); once the bad fraction of a stream
# exceeds this — with at least MIN_BAD_ROWS_FOR_WARNING seen, so one
# mangled line in a ten-row fixture doesn't cry wolf — a loud
# RuntimeWarning names the file. Raw Criteo-1TB has occasional mangled
# lines; a reader that crashes the whole epoch on row 2.1e9 (the old
# behavior: ValueError out of `int(v, 16)`) or silently drops half the
# file (a format mismatch) are both failure modes this guards.
BAD_ROW_WARN_FRACTION = 0.01
MIN_BAD_ROWS_FOR_WARNING = 32


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — deterministic int64 avalanche."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> np.uint64(33))


def hash_bucket(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Map raw int64 feature values into [0, num_buckets) (int32 if it fits)."""
    out = mix64(values) % np.uint64(num_buckets)
    return out.astype(np.int32 if num_buckets <= 2**31 else np.int64)


def _squash_dense(cols: np.ndarray) -> np.ndarray:
    """log1p squash of the integer count features (standard Criteo recipe;
    negatives -> 0). The reference's csv path bakes MinMaxScaler into the
    file instead (examples/criteo_preprocess.py)."""
    return np.log1p(np.maximum(cols.astype(np.float32), 0.0))


def parse_tsv_row(line: str) -> Optional[Tuple[float, list, list]]:
    """One raw Criteo TSV row -> ``(label, dense ints, sparse ints)``,
    or None for a row that cannot be parsed (wrong field count, a
    non-hex categorical, a non-numeric count) — the caller skips and
    counts it (:func:`note_bad_rows`). Missing fields parse as 0;
    categoricals get +1 so a present ``0`` id stays distinct from a
    missing one."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) != 1 + NUM_DENSE + NUM_SPARSE:
        return None
    try:
        label = float(parts[0] or 0)
        dense = [int(v) if v else 0 for v in parts[1:1 + NUM_DENSE]]
        sparse = [int(v, 16) + 1 if v else 0
                  for v in parts[1 + NUM_DENSE:]]
    except ValueError:
        return None
    return label, dense, sparse


def note_bad_rows(n_new: int, n_bad: int, n_total: int, source: str,
                  warned: list, *,
                  threshold: float = BAD_ROW_WARN_FRACTION) -> None:
    """Account ``n_new`` newly skipped rows: bumps the global
    ``ingest_bad_rows`` counter and — once per ``warned`` box, when the
    CUMULATIVE bad fraction ``n_bad / n_total`` crosses ``threshold``
    with at least :data:`MIN_BAD_ROWS_FOR_WARNING` bad rows seen —
    emits a loud RuntimeWarning naming ``source``. ``warned`` is a
    caller-held mutable box (``[]`` = not yet warned) so one stream
    warns once, not per batch."""
    if not n_new:
        return
    from ..utils import observability
    observability.GLOBAL.add("ingest_bad_rows", float(n_new))
    if not warned and n_bad >= MIN_BAD_ROWS_FOR_WARNING \
            and n_bad > threshold * max(1, n_total):
        warned.append(True)
        warnings.warn(
            f"{source}: skipped {n_bad} unparseable row(s) of "
            f"{n_total} ({n_bad / max(1, n_total):.1%} > "
            f"{threshold:.1%} threshold) — wrong column count or "
            "non-hex categoricals; is this really raw Criteo TSV "
            "(label \\t 13 ints \\t 26 hex)?", RuntimeWarning,
            stacklevel=3)


def read_criteo_tsv(path: str, batch_size: int, *,
                    num_buckets: int = 1 << 25,
                    max_batches: Optional[int] = None,
                    drop_remainder: bool = True) -> Iterator[Dict]:
    """Stream batches from a raw Criteo TSV (label \\t 13 ints \\t 26 hex).

    Unparseable rows are SKIPPED and counted (``ingest_bad_rows``
    global counter; loud RuntimeWarning past
    :data:`BAD_ROW_WARN_FRACTION`) — a single mangled line must not
    crash an epoch 2 billion rows in. The parallel shard-pool fast path
    is ``data.stream.ShardStream``; this is its portable single-file
    reference (same row semantics, same bad-row accounting).
    """
    labels, dense, sparse = [], [], []
    produced = 0
    n_bad = n_total = 0
    warned: list = []
    with open(path, "r") as f:
        for line in f:
            n_total += 1
            row = parse_tsv_row(line)
            if row is None:
                n_bad += 1
                note_bad_rows(1, n_bad, n_total, path, warned)
                continue
            labels.append(row[0])
            dense.append(row[1])
            sparse.append(row[2])
            if len(labels) == batch_size:
                yield _emit(labels, dense, sparse, num_buckets)
                labels, dense, sparse = [], [], []
                produced += 1
                if max_batches and produced >= max_batches:
                    return
    if labels and not drop_remainder:
        yield _emit(labels, dense, sparse, num_buckets)


def _emit(labels, dense, sparse, num_buckets) -> Dict:
    sp = np.asarray(sparse, dtype=np.int64)
    return {
        "label": np.asarray(labels, dtype=np.float32),
        "dense": _squash_dense(np.asarray(dense)),
        "sparse": {name: hash_bucket(sp[:, j], num_buckets)
                   for j, name in enumerate(SPARSE_NAMES)},
    }


def read_criteo_csv(path: str, batch_size: int, *,
                    max_batches: Optional[int] = None,
                    drop_remainder: bool = True) -> Iterator[Dict]:
    """Preprocessed csv (header row: label,I1..I13,C1..C26; numerics scaled,
    categoricals already label-encoded ints) — the examples' train100.csv
    format."""
    import csv as csv_mod
    with open(path, "r") as f:
        reader = csv_mod.reader(f)
        header = next(reader)
        idx = {name: header.index(name) for name in
               ("label",) + DENSE_NAMES + SPARSE_NAMES}
        labels, dense, sparse = [], [], []
        produced = 0
        for row in reader:
            labels.append(float(row[idx["label"]]))
            dense.append([float(row[idx[n]] or 0) for n in DENSE_NAMES])
            sparse.append([int(float(row[idx[n]] or 0)) for n in SPARSE_NAMES])
            if len(labels) == batch_size:
                yield _emit_csv(labels, dense, sparse)
                labels, dense, sparse = [], [], []
                produced += 1
                if max_batches and produced >= max_batches:
                    return
        if labels and not drop_remainder:
            yield _emit_csv(labels, dense, sparse)


def _emit_csv(labels, dense, sparse):
    sp = np.asarray(sparse, dtype=np.int64)
    return {
        "label": np.asarray(labels, np.float32),
        "dense": np.asarray(dense, np.float32),
        "sparse": {n: sp[:, j].astype(np.int32)
                   for j, n in enumerate(SPARSE_NAMES)},
    }


def synthetic_criteo(batch_size: int, *,
                     num_buckets: int = 1 << 20,
                     seed: int = 0,
                     num_batches: Optional[int] = None,
                     zipf_a: float = 1.2) -> Iterator[Dict]:
    """Deterministic Criteo-shaped stream with zipfian id frequency (real
    click logs are heavy-tailed; uniform ids over-estimate dedup wins)."""
    rng = np.random.RandomState(seed)
    i = 0
    while num_batches is None or i < num_batches:
        raw = rng.zipf(zipf_a, size=(batch_size, NUM_SPARSE)).astype(np.int64)
        sparse = {}
        for j, name in enumerate(SPARSE_NAMES):
            # decorate per-feature so columns don't share id streams
            sparse[name] = hash_bucket(raw[:, j] * np.int64(j + 1), num_buckets)
        dense = _squash_dense(rng.poisson(3.0, size=(batch_size, NUM_DENSE)))
        label = (rng.rand(batch_size) > 0.75).astype(np.float32)
        yield {"label": label, "dense": dense, "sparse": sparse}
        i += 1


def add_linear_columns(batches: Iterable[Dict],
                       suffix: str = ":linear") -> Iterator[Dict]:
    """Duplicate each sparse column under its ':linear' name so models with a
    first-order term see both (same ids, separate dim-1 variable)."""
    for b in batches:
        sp = dict(b["sparse"])
        for name in list(b["sparse"]):
            sp[name + suffix] = b["sparse"][name]
        yield {**b, "sparse": sp}


def prefetch(batches: Iterable[Dict], place_fn, depth: int = 2) -> Iterator:
    """Double-buffered host->device pipeline: keeps ``depth`` placed
    batches in flight. ``place_fn`` is typically ``Trainer.place_batch``
    (fresh device tensors, copies that do not wait), the JAX package's
    ``trainer.shard_batch``."""
    queue = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            queue.append(place_fn(next(it)))
    except StopIteration:
        pass
    while queue:
        try:
            queue.append(place_fn(next(it)))
        except StopIteration:
            pass
        yield queue.popleft()
