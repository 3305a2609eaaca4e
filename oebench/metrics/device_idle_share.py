"""device_idle_share (%): the share of the measured window's time in which
no kernel, copy or fill ran on the device.

The device's busy time a step comes from the traced window (the union of
its kernels, copies and fills, ``oebench/trace.py``, over its steps); the
time a step takes comes from the untraced window (its wall time over its
steps). The traced window's own length is not used: the profiler adds its
cost at every graph launch on the host (about half a millisecond a step on
an H100 for a graph of 285 kernels), which would read as idle device time
on a step the host paces. Busy time within a step is the device's own, and
the profiler leaves it nearly as it is.
"""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device or not trace.steps \
            or not ctx.steps or ctx.window_s <= 0:
        return None
    busy_per_step = trace.busy_us / 1e6 / trace.steps
    return 100.0 * (1.0 - busy_per_step / (ctx.window_s / ctx.steps))
