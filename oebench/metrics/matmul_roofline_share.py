"""matmul_roofline_share (%): the step's matrix products, their least time
over their time in the trace.

The least time is the step's matrix-product operations over the float32
peak (``oebench/peaks.py``; the configuration computes in float32 with
TF32 off, outside the tensor cores): the model's ``matmul_flops(config)``
(``reference/<model>.py``; for xDeepFM the CIN's compressions, the tower
and the two output layers, each multiply-add two operations, forward and
both gradients). A product this large is bound by its operations, not its
bytes. The time is the summed duration of the traced window's kernels
whose names hold ``gemm``, ``gemv`` or ``splitKreduce`` (cuBLAS's and
CUTLASS's products and their split-K reductions) or ``cin`` as a word of
its own, over the traced steps. Any kernel of the port that later takes
over a matrix product carries ``cin`` or ``gemm`` in its name, so the
share keeps reading the same work.

Nothing to read, and no value, for a model whose reference counts no
matrix products or in a window that ran none of these kernels.
"""

from __future__ import annotations

import re

from oebench import peaks
from oebench.reference import model

PATTERN = re.compile(r"gemm|gemv|splitkreduce|(?<![a-z])cin(?![a-z])")


def matched(name: str) -> bool:
    """Whether a kernel's name marks a matrix product."""
    return PATTERN.search(name.lower()) is not None


def kernel_names(trace) -> list:
    """The distinct names of the window's matched kernels."""
    return sorted({name for name, cat, _ts, _dur in trace.device
                   if cat == "kernel" and matched(name)})


def read(ctx):
    net = model(ctx.config)
    if ctx.trace is None or not ctx.trace.steps \
            or not hasattr(net, "matmul_flops"):
        return None
    us = sum(dur for name, cat, _ts, dur in ctx.trace.device
             if cat == "kernel" and matched(name))
    if not us:
        return None
    least_s = net.matmul_flops(ctx.config) / peaks.FP32_FLOPS
    return 100.0 * least_s / (us / 1e6 / ctx.trace.steps)
