"""k2_roofline_share (%): K2, the probe gather of a hash table's pull
(``openembedding_tpu_torch/ops/probe_gather.py``, ``csrc/probe_gather.cu``),
its least time over its time in the trace.

A probe gather's least time is its bytes over the HBM peak, counted for
the data at hand (the repository's ``chip_smoke.probe_bound_bytes``,
frozen here): keys are never freed and a bucket fills front to back, so a
query's scan of its window may stop at its match or at the first empty
slot; the key sectors from each valid query's window start through that
slot, each sector once over all queries, plus the 32-byte sectors of the
distinct matched rows, the queries read, and the rows and hit flags
written. Where each key's window starts is the table's layout (buckets of
128 slots, chains of two buckets, a 32-bit avalanche of the key's words),
frozen here too; the keys' places are read from the table.

Each traced step launches K2 once a table on that step's keys. The share
is the least time of a launch, averaged over the traced steps (at most
:data:`SAMPLE` of them, evenly spaced) and tables, times the launches the
trace holds, over their summed kernel time.
"""

from __future__ import annotations

import numpy as np
import torch

from oebench import peaks
from oebench.initial import table_dims

KERNELS = ("probe_gather_kernel",)
SECTOR = 32
SAMPLE = 32
BUCKET = 128
MAX_PROBES = 256
EMPTY = -2**31
MASK32 = 0xFFFFFFFF


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche over a key's (lo, hi) words, in [0, 2^32)."""
    a = lo.to(torch.int64) & MASK32
    b = hi.to(torch.int64) & MASK32
    h = a ^ _mul32(b, 0x9E3779B9)
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = h ^ b
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def layout(capacity: int):
    """(slots a bucket, buckets, buckets a chain)."""
    b = min(BUCKET, capacity)
    nb = capacity // b
    return b, nb, max(1, min(MAX_PROBES // b, nb))


def union_length(lo: np.ndarray, hi: np.ndarray) -> int:
    """Size of the union of the integer ranges ``[lo, hi]``."""
    if not lo.size:
        return 0
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    covered = np.concatenate([[lo[0] - 1], np.maximum.accumulate(hi)[:-1]])
    return int(np.maximum(0, hi - np.maximum(lo - 1, covered)).sum())


def row_sector_bytes(row_bytes: int, rows: np.ndarray) -> int:
    uniq = np.unique(rows).astype(np.int64)
    if not uniq.size:
        return 0
    first = uniq * row_bytes // SECTOR
    last = (uniq * row_bytes + row_bytes - 1) // SECTOR
    spans = [first + k for k in range(int((last - first).max()) + 1)]
    return int(np.unique(np.concatenate(
        [s[s <= last] for s in spans])).size * SECTOR)


def probe_bound_bytes(keys: torch.Tensor, row_bytes: int,
                      query: torch.Tensor) -> int:
    """Bytes a probe gather of ``query`` ``[n, 2]`` from a table of wide
    ``keys`` ``[capacity, 2]`` must move."""
    bsz, nb, chain = layout(keys.shape[0])
    valid = query[:, 1] != EMPTY
    q = query[valid]
    start = (mix_pair(q[:, 0], q[:, 1]) % (nb - chain + 1)) * bsz
    span = chain * bsz
    window = keys[start[:, None] + torch.arange(span, device=keys.device)]
    match = (window == q[:, None, :]).all(-1)
    free = window[..., 1] == EMPTY
    found = match.any(1)
    first_match = match.to(torch.uint8).argmax(1)
    stop = torch.where(
        found, first_match,
        torch.where(free.any(1), free.to(torch.uint8).argmax(1), span - 1))
    slots = (start + first_match)[found]
    start, stop = start.cpu().numpy(), stop.cpu().numpy()
    needed = union_length(start * 8 // SECTOR,
                          ((start + stop + 1) * 8 - 1) // SECTOR)
    n = query.shape[0]
    return (needed * SECTOR
            + row_sector_bytes(row_bytes, slots.cpu().numpy())
            + n * 8 + n * row_bytes + n)


def read(ctx):
    config = ctx.config
    if ctx.trace is None or config["table"] != "hash":
        return None
    times = ctx.trace.kernels(KERNELS)
    if not times:
        return None
    steps = ctx.trace.batch_indices
    sample = [steps[i] for i in np.unique(
        np.linspace(0, len(steps) - 1, min(SAMPLE, len(steps))).astype(int))]
    name = config["fused_name"]
    least = []
    for leaf, dim in table_dims(config).items():
        keys = ctx.state.emb[leaf].keys
        for p in sample:
            query = torch.from_numpy(np.ascontiguousarray(
                ctx.batches[p]["sparse"][name]).reshape(-1, 2)).to(
                    keys.device)
            least.append(probe_bound_bytes(keys, dim * 4, query)
                         / peaks.HBM_BYTES)
    return 100.0 * float(np.mean(least)) * len(times) / (sum(times) / 1e6)
