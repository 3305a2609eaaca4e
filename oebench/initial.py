"""A cell's initial values, drawn on the device from the seed.

The benchmark hands the same values to the program and to the reference:

* an array table's rows: ``normal(0, init_stddev)``, drawn in chunks of
  :data:`CHUNK` rows, each chunk from a generator of its own, so that any
  chunk can be drawn again alone;
* a hash table's rows: one row per key of the configuration's vocabulary
  (every key its features can take, sorted), drawn the same way in chunks
  of keys;
* the optimizer accumulators: the configuration's initial value;
* the dense weights: ``normal(0, 1 / sqrt(fan_in))``; biases zero.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .reference import model
from .reference.mapping import vocab_sizes
from .traffic import seed_of

CHUNK = 1 << 21


def table_dims(config: dict) -> Dict[str, int]:
    """The fused tables of ``config``'s model, by the names their leaves
    carry, with their widths."""
    return model(config).tables(config)


def table_rows(config: dict) -> int:
    """Rows of an array table: every feature's vocabulary, concatenated."""
    return int(vocab_sizes(config).sum())


class Initial:
    """The initial values of one run. ``keys``: a hash cell's sorted
    int64 keys (None for array tables)."""

    def __init__(self, config: dict, seed: int, device,
                 keys: Optional[np.ndarray] = None):
        self.config = config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.keys = keys
        self.std = float(config["init_stddev"])
        self.dims = table_dims(config)

    def _generator(self, *tags) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_of(self.seed, *tags))
        return g

    def _draw(self, n: int, dim: int, *tags) -> torch.Tensor:
        return torch.randn((n, dim), generator=self._generator(*tags),
                           device=self.device) * self.std

    @property
    def sparse_accumulator(self) -> float:
        return float(self.config["sparse_optimizer"][
            "initial_accumulator_value"])

    @property
    def dense_accumulator(self) -> float:
        return float(self.config["dense_optimizer"][
            "initial_accumulator_value"])

    # --- array tables -------------------------------------------------------
    def array_chunk(self, leaf: str, c: int) -> torch.Tensor:
        """Rows ``[c * CHUNK, (c + 1) * CHUNK)`` of an array table."""
        n = min(CHUNK, table_rows(self.config) - c * CHUNK)
        return self._draw(n, self.dims[leaf], "array", leaf, c)

    def array_rows(self, leaf: str, rows: np.ndarray) -> torch.Tensor:
        """The initial rows ``rows`` (int64, valid) of an array table."""
        rows = np.asarray(rows, np.int64)
        out = torch.empty((rows.size, self.dims[leaf]), device=self.device)
        chunk = rows // CHUNK
        for c in np.unique(chunk):
            at = np.nonzero(chunk == c)[0]
            local = torch.from_numpy(rows[at] - c * CHUNK).to(self.device)
            out[torch.from_numpy(at).to(self.device)] = \
                self.array_chunk(leaf, int(c))[local]
        return out

    # --- hash tables --------------------------------------------------------
    def hash_all(self, leaf: str) -> torch.Tensor:
        """The rows of every key of ``keys``, in key order."""
        n = int(self.keys.size)
        return torch.cat([self._draw(min(CHUNK, n - lo), self.dims[leaf],
                                     "hash", leaf, lo // CHUNK)
                          for lo in range(0, n, CHUNK)]) if n else \
            torch.empty((0, self.dims[leaf]), device=self.device)

    def hash_rows(self, leaf: str, keys: np.ndarray) -> torch.Tensor:
        """The initial rows of ``keys`` (each one of ``self.keys``)."""
        pos = np.searchsorted(self.keys, keys)
        if not np.array_equal(self.keys[np.minimum(pos, self.keys.size - 1)],
                              keys):
            raise KeyError("hash_rows: a key outside the pool's keys")
        return self.hash_all(leaf)[torch.from_numpy(pos).to(self.device)]

    # --- dense parameters ---------------------------------------------------
    def dense(self) -> Dict[str, torch.Tensor]:
        """Every dense parameter by name (the model's
        ``param_shapes``)."""
        out = {}
        for name, shape in model(self.config).param_shapes(self.config):
            if name.endswith(".weight"):
                out[name] = torch.randn(
                    shape, generator=self._generator("dense", name),
                    device=self.device) / float(np.sqrt(shape[1]))
            else:
                out[name] = torch.zeros(shape, device=self.device)
        return out
