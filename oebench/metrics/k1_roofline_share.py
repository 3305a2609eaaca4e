"""k1_roofline_share (%): K1, the row gather of an array table's pull
(``openembedding_tpu_torch/ops/gather.py``, ``csrc/gather_rows.cu``),
its least time over its time in the trace.

A gather's least time is its bytes over the HBM peak: the 32-byte sectors
that hold the distinct valid rows, each read once, plus the ids read and
the rows written (the repository's ``chip_smoke.gather_bound_bytes``,
frozen here). Each traced step launches K1 once a table on that step's
fused ids. The share is the least time of a launch, averaged over the
traced steps (at most :data:`SAMPLE` of them, evenly spaced) and tables,
times the launches the trace holds, over their summed kernel time.
"""

from __future__ import annotations

import numpy as np

from oebench import peaks
from oebench.initial import table_dims, table_rows

KERNELS = ("gather_fixed", "gather_tile", "gather_units")
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
SECTOR = 32
SAMPLE = 32


def row_sector_bytes(row_bytes: int, rows: np.ndarray) -> int:
    """Bytes of the 32-byte sectors holding the given rows, each sector
    counted once."""
    uniq = np.unique(rows).astype(np.int64)
    if not uniq.size:
        return 0
    first = uniq * row_bytes // SECTOR
    last = (uniq * row_bytes + row_bytes - 1) // SECTOR
    spans = [first + k for k in range(int((last - first).max()) + 1)]
    return int(np.unique(np.concatenate(
        [s[s <= last] for s in spans])).size * SECTOR)


def gather_bound_bytes(rows: int, row_bytes: int, ids: np.ndarray) -> int:
    """Bytes a gather of ``ids`` from a ``rows``-row table must move."""
    valid = ids[(ids >= 0) & (ids < rows)]
    return (row_sector_bytes(row_bytes, valid) + ids.size * ids.itemsize
            + ids.size * row_bytes)


def read(ctx):
    config = ctx.config
    if ctx.trace is None or config["table"] != "array":
        return None
    times = ctx.trace.kernels(KERNELS)
    if not times:
        return None
    steps = ctx.trace.batch_indices
    sample = [steps[i] for i in np.unique(
        np.linspace(0, len(steps) - 1, min(SAMPLE, len(steps))).astype(int))]
    rows = table_rows(config)
    name = config["fused_name"]
    element = ELEMENT_BYTES[config["dtype"]]
    least = [gather_bound_bytes(rows, dim * element,
                                np.asarray(ctx.batches[p]["sparse"][name]))
             / peaks.HBM_BYTES
             for p in sample for dim in table_dims(config).values()]
    return 100.0 * float(np.mean(least)) * len(times) / (sum(times) / 1e6)
