"""train_mfu (%): the step's least time on the chip over its measured time.

The least time is the larger of the step's operations over the float32
peak (the configuration computes in float32 with TF32 off, so outside the
tensor cores) and its bytes over the HBM peak (``oebench/peaks.py``).

* Operations, from the configuration's shapes: the model's forward pass
  as its reference counts it (``reference/<model>.py``
  ``forward_flops``; for DeepFM the tower's multiply-adds at two
  operations each, the FM term's and the linear term's elementwise
  operations at one each), times three for the forward and backward
  passes.
* Bytes, from each batch's own distinct table entries: each distinct row
  of each table and its Adagrad accumulator read and written once, each id
  read once, and each dense parameter and its accumulator read and written
  once; averaged over the pool's batches, which the window cycles through.

The measured time per step is the untraced window's wall time over its
steps, on the host's clock, so the metric's source is the host's clock: it
reads nothing from the trace. The count is the same whatever implements
the step.
"""

from __future__ import annotations

import numpy as np

from oebench import peaks
from oebench.initial import table_dims
from oebench.reference import model
from oebench.reference.train import touched_ids

FLOAT = 4


def step_flops(config: dict) -> float:
    return 3.0 * model(config).forward_flops(config)


def step_bytes(config: dict, ids: np.ndarray) -> float:
    """Bytes of one step on per-feature ids ``[B, F]``."""
    entries = touched_ids(config, ids)
    distinct = np.unique(entries[entries >= 0] if config["table"] != "hash"
                         else entries).size
    id_bytes = 8 if config["table"] == "hash" else 4
    total = 0.0
    for dim in table_dims(config).values():
        total += distinct * dim * FLOAT * 2 * 2   # row + accumulator, r + w
        total += entries.size * id_bytes           # the ids, read once
    params = sum(int(np.prod(s))
                 for _, s in model(config).param_shapes(config))
    return total + params * FLOAT * 2 * 2


def read(ctx):
    if not ctx.steps or not ctx.window_s:
        return None
    config = ctx.config
    flops = step_flops(config)
    nbytes = float(np.mean([step_bytes(config, ctx.pool.ids[p])
                            for p in range(len(ctx.pool))]))
    least = max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES)
    return 100.0 * least / (ctx.window_s / ctx.steps)
