"""device_ops_per_step (ops/step): the traced window's kernels, copies and
fills over its steps (``oebench/trace.py``)."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device or not trace.steps:
        return None
    return len(trace.device) / trace.steps
