"""Criteo-shaped data (``openembedding_tpu/data/criteo.py``): feature names,
the deterministic synthetic stream and ``add_linear_columns``.

``synthetic_criteo`` reproduces the JAX package's generator draw for draw
(same ``numpy.random.RandomState`` sequence, same splitmix64 bucket hash),
so a seed gives both packages the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26
DENSE_NAMES = tuple(f"I{i}" for i in range(1, NUM_DENSE + 1))
SPARSE_NAMES = tuple(f"C{i}" for i in range(1, NUM_SPARSE + 1))


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


def synthetic_criteo(batch_size: int, *,
                     num_buckets: int = 1 << 20,
                     seed: int = 0,
                     num_batches: Optional[int] = None,
                     zipf_a: float = 1.2) -> Iterator[Dict]:
    """Deterministic Criteo-shaped stream with zipfian id frequency."""
    rng = np.random.RandomState(seed)
    i = 0
    while num_batches is None or i < num_batches:
        raw = rng.zipf(zipf_a, size=(batch_size, NUM_SPARSE)).astype(np.int64)
        sparse = {}
        for j, name in enumerate(SPARSE_NAMES):
            # decorate per-feature so columns don't share id streams
            sparse[name] = hash_bucket(raw[:, j] * np.int64(j + 1),
                                       num_buckets)
        dense = np.log1p(np.maximum(
            rng.poisson(3.0, size=(batch_size, NUM_DENSE)).astype(np.float32),
            0.0))
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
