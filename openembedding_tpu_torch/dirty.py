"""Chunk-level dirty tracking for incremental (delta) checkpoints (the
port's copy of ``openembedding_tpu/dirty.py``).

One bitmap per variable, fed by the pushes (the ``Trainer`` marks each
step's host batch, an eager ``EmbeddingCollection.apply_gradients``
marks its own ids), so ``checkpoint.save_checkpoint(mode="delta")``
writes only the chunks that changed since the last save. Granularity is
a chunk of rows, not a row: the bitmap stays O(vocab / rows_per_chunk)
and every delta file is a run of contiguous row ranges.

* array tables: logical row id -> chunk ``id // rows_per_chunk``
  (:meth:`DirtyTracker.mark_rows`); a chunk is the contiguous logical
  range ``[c * R, min((c+1) * R, vocab))``;
* hash tables: 64-bit key -> chunk ``key % num_chunks``
  (:meth:`DirtyTracker.mark_keys`); a chunk is the set of live keys whose
  joined 64-bit value falls in it;
* optimizer slots are co-indexed with their weights: a delta writes
  weights and slots of every dirty chunk.

Every bitmap access holds the tracker's lock: marks land from the step
loop while a save claims (:meth:`DirtyTracker.snapshot_clear`) or a
failed save gives back (:meth:`DirtyTracker.restore`) its chunks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .analysis.concurrency import make_lock, sync_point


class DirtyTracker:
    """Chunk-granular dirty bitmap with an exact dirty count.

    All methods are thread-safe under the tracker's lock (or the shared
    lock passed at construction). Over-marking is always safe — a chunk
    marked dirty that did not change costs delta bytes, never
    correctness — so producers may mark conservatively (e.g. every batch
    id, including ids whose gradient was zero).
    """

    def __init__(self, num_chunks: int, *, rows_per_chunk: int = 1,
                 name: str = "", lock=None):
        if num_chunks <= 0:
            raise ValueError(f"num_chunks must be positive, got {num_chunks}")
        if rows_per_chunk <= 0:
            raise ValueError(
                f"rows_per_chunk must be positive, got {rows_per_chunk}")
        self.num_chunks = int(num_chunks)
        self.rows_per_chunk = int(rows_per_chunk)
        self.name = name
        self._bits = np.zeros(self.num_chunks, bool)
        self._count = 0
        # make_lock: a plain Lock unless OE_REPORT_TRACE_LOCKS arms the
        # runtime detector (analysis/concurrency.py); a shared lock may
        # be an RLock, only ``with`` is used
        self._lock = lock if lock is not None \
            else make_lock(f"dirty.{name or 'tracker'}")

    # --- mapping -----------------------------------------------------------
    def chunks_of_rows(self, ids) -> np.ndarray:
        """Chunk index for each logical row id (out-of-range ids are the
        caller's concern; :meth:`mark_chunks` drops them)."""
        ids = np.asarray(ids, np.int64).ravel()
        if self.rows_per_chunk == 1:
            return ids
        return ids // self.rows_per_chunk

    def chunks_of_keys(self, keys64) -> np.ndarray:
        """Chunk index for 64-bit hash keys: nonnegative ``key % n``
        (numpy's mod of a negative int by a positive is nonnegative, so
        negative keys land in a valid chunk)."""
        keys = np.asarray(keys64, np.int64).ravel()
        return keys % np.int64(self.num_chunks)

    def chunk_row_range(self, chunk: int, vocab: int):
        """Logical row range ``[lo, hi)`` of one array-table chunk."""
        lo = int(chunk) * self.rows_per_chunk
        return lo, min(lo + self.rows_per_chunk, int(vocab))

    # --- marking -----------------------------------------------------------
    def mark_rows(self, ids) -> None:
        self.mark_chunks(self.chunks_of_rows(ids))

    def mark_keys(self, keys64) -> None:
        self.mark_chunks(self.chunks_of_keys(keys64))

    def mark_chunks(self, chunks) -> None:
        chunks = np.asarray(chunks, np.int64).ravel()
        chunks = chunks[(chunks >= 0) & (chunks < self.num_chunks)]
        if not chunks.size:
            return
        # interleaving marker OUTSIDE the lock: a gated test parks the
        # marking thread here without wedging the bitmap for others
        # (graftproto dirty_tracker model action `mark`)
        sync_point("dirty.mark")
        with self._lock:
            fresh = chunks[~self._bits[chunks]]
            if fresh.size:
                fresh = np.unique(fresh)
                self._bits[fresh] = True
                self._count += int(fresh.size)

    def mark_all(self) -> None:
        with self._lock:
            self._bits[:] = True
            self._count = self.num_chunks

    # --- clearing / snapshots ----------------------------------------------
    def clear_chunks(self, chunks) -> None:
        chunks = np.asarray(chunks, np.int64).ravel()
        chunks = chunks[(chunks >= 0) & (chunks < self.num_chunks)]
        if not chunks.size:
            return
        with self._lock:
            set_ = chunks[self._bits[chunks]]
            if set_.size:
                set_ = np.unique(set_)
                self._bits[set_] = False
                self._count -= int(set_.size)

    def clear_all(self) -> None:
        with self._lock:
            self._bits[:] = False
            self._count = 0

    def dirty_chunks(self) -> np.ndarray:
        """Sorted dirty chunk ids (a snapshot; bits stay set)."""
        with self._lock:
            return np.nonzero(self._bits)[0]

    def snapshot_clear(self) -> np.ndarray:
        """Atomically take the dirty set and clear it — the delta writer's
        claim. On a FAILED write the caller must :meth:`restore` the
        snapshot so the next save re-covers those chunks (marks landing
        during the failed write are preserved either way: clearing is
        exact-set, not wholesale)."""
        with self._lock:
            chunks = np.nonzero(self._bits)[0]
            self._bits[:] = False
            self._count = 0
        sync_point("dirty.snapshot")
        return chunks

    def restore(self, chunks) -> None:
        """Re-mark a failed writer's snapshot (over-marking chunks that
        were re-dirtied meanwhile is harmless)."""
        sync_point("dirty.restore")
        self.mark_chunks(chunks)

    def mask_chunks(self, chunks) -> np.ndarray:
        """Dirty bit for each chunk index (out-of-range reads as clean)."""
        chunks = np.asarray(chunks, np.int64).ravel()
        ok = (chunks >= 0) & (chunks < self.num_chunks)
        out = np.zeros(chunks.shape, bool)
        with self._lock:
            out[ok] = self._bits[chunks[ok]]
        return out

    def mask_rows(self, ids) -> np.ndarray:
        return self.mask_chunks(self.chunks_of_rows(ids))

    def __getitem__(self, ids):
        """Row-indexed dirty read (``tracker[ids]``)."""
        out = self.mask_rows(ids)
        if isinstance(ids, (int, np.integer)):
            return bool(out[0])
        return out

    # --- introspection -----------------------------------------------------
    @property
    def dirty_count(self) -> int:
        with self._lock:
            return self._count

    @property
    def nbytes(self) -> int:
        """Bitmap bytes (graftwatch host-memory ledger)."""
        return int(self._bits.nbytes)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"DirtyTracker({self.name!r}, chunks={self.num_chunks}, "
                f"rows_per_chunk={self.rows_per_chunk}, "
                f"dirty={self.dirty_count})")


def make_array_tracker(name: str, vocab: int,
                       target_chunks: int = 1024,
                       lock=None) -> DirtyTracker:
    """Tracker for a bounded (array) variable: ~``target_chunks`` chunks
    of contiguous logical rows (at least one row per chunk)."""
    vocab = max(1, int(vocab))
    rows = max(1, -(-vocab // max(1, int(target_chunks))))
    return DirtyTracker(-(-vocab // rows), rows_per_chunk=rows,
                        name=name, lock=lock)


def make_hash_tracker(name: str, capacity: int,
                      target_chunks: int = 1024,
                      lock=None) -> DirtyTracker:
    """Tracker for a hash variable: key-space partitioned into
    ``min(target_chunks, capacity)`` chunks by ``key % n``."""
    n = max(1, min(int(target_chunks), max(1, int(capacity))))
    return DirtyTracker(n, name=name, lock=lock)
