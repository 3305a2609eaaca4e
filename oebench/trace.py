"""A profiler trace of a window of steps, and its reduction.

:func:`traced_window` runs one lead-in step (the profiler may miss the
first kernels of its trace) and then ``steps`` steps inside a window
opened and closed with the device idle, under ``torch.profiler``, writes
the chrome trace to a temporary file under ``TMPDIR``, reads it and
deletes it. On a CUDA device it records the device's activity alone (the
kernels, copies and fills, and the CUDA runtime calls that launched them),
which is the least the profiler can add to a step: recording the host's
operators as well adds their cost on top. Even so each graph launch takes
longer under the profiler, so the traced window's length is the
profiler's as much as the program's; the metrics take the device's busy
time a step from the trace and the time a step takes from the untraced
window. The window is the annotation that wraps it where the host's
operators are recorded (on the CPU), else the span from the end of the
synchronization before its first step to the end of the one after its
last.

:func:`reduce_trace` is the arithmetic of the repository's
``chip_smoke.training_trace``, frozen here: the device's work is every
kernel, copy and fill whose start lies in the window, plus the kernels of
the window's graph replays, found by their ``cudaGraphLaunch``'s
correlation id (the device clock, mapped onto the host's, can place a
replay's first kernels a little before the window opens); busy time is the
union of their spans within the window; each idle gap between them is put
down to the innermost host event (a runtime call, or an operator where
those are recorded) open at its midpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

WINDOW = "oebench.traced_steps"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SYNC = "cudaDeviceSynchronize"


@dataclasses.dataclass
class Trace:
    steps: int
    batch_indices: List[int]     # the pool batch of each traced step
    window_us: float             # the annotated window's length
    busy_us: float               # union of device work in the window
    device: List[Tuple[str, str, float, float]]   # (name, cat, ts, dur)
    gaps: List[Tuple[float, float]]
    idle_by_host: Dict[str, float]                # microseconds by name
    host_window_us: float = 0.0  # the window on the host's clock

    def kernels(self, names) -> List[float]:
        """Durations (us) of the window's kernels whose name holds one of
        ``names`` as ``::name<`` or ``::name(``."""
        return [dur for name, cat, _ts, dur in self.device
                if cat == "kernel" and any(
                    f"::{k}<" in name or f"::{k}(" in name for k in names)]

    def by_name(self) -> Dict[str, float]:
        """Device microseconds by operation name."""
        out: Dict[str, float] = {}
        for name, _cat, _ts, dur in self.device:
            out[name[:120]] = out.get(name[:120], 0.0) + dur
        return out


def traced_window(trainer, state, batches, first: int, steps: int):
    """Trace ``steps`` steps on ``batches[first + 1 ...]`` (cycling) after
    a lead-in step on ``batches[first]``. Returns ``(state, Trace)``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = trainer.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    n = len(batches)
    indices = [(first + 1 + i) % n for i in range(steps)]
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        state, _ = trainer.train_step(state, batches[first % n])
        sync()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for i in indices:
                state, _ = trainer.train_step(state, batches[i])
            sync()
        host_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(suffix=".json", prefix="oebench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    traced = reduce_trace(events, indices)
    traced.host_window_us = host_us
    return state, traced


def idle_by_host(gaps, host, top: int = 10) -> Dict[str, float]:
    """Each gap put down to the innermost host event (op, annotation or
    runtime call) open at its midpoint; microseconds by name, the ``top``
    largest."""
    host = sorted(host)
    out: Dict[str, float] = {}
    active, j = [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [e for e in active if e[1] >= mid]
        name = min(active, key=lambda e: e[1] - e[0])[2][:120] if active \
            else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def window_of(events: List[dict]) -> Tuple[float, float]:
    """The traced window: its annotation, else from the end of the first
    device synchronization to the end of the last."""
    for e in events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    ends = sorted(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
                  if e.get("cat") == "cuda_runtime" and e.get("name") == SYNC)
    if len(ends) < 2:
        raise ValueError("the trace holds neither the window's annotation "
                         "nor the synchronizations around it")
    return ends[0], ends[-1]


def reduce_trace(events: List[dict], indices: List[int]) -> Trace:
    w0, w1 = window_of(events)
    inside = [e for e in events if "ts" in e and w0 <= float(e["ts"]) <= w1]
    replays = {e.get("args", {}).get("correlation") for e in inside
               if e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaGraphLaunch"}
    replays.discard(None)
    picked = {id(e): e for e in inside if e.get("cat") in DEVICE_CATS}
    for e in events:
        if e.get("cat") == "kernel" \
                and e.get("args", {}).get("correlation") in replays:
            picked[id(e)] = e
    device = sorted(((e["name"], e["cat"], float(e["ts"]),
                      float(e.get("dur", 0.0))) for e in picked.values()),
                    key=lambda d: d[2])
    busy, gaps, end = 0.0, [], None
    for _name, _cat, ts, dur in device:
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in inside if e.get("cat") in HOST_CATS and "dur" in e]
    return Trace(steps=len(indices), batch_indices=list(indices),
                 window_us=w1 - w0, busy_us=busy, device=device, gaps=gaps,
                 idle_by_host=idle_by_host(gaps, host))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The longest device operations and idle gaps by host activity, in
    seconds."""
    ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in ops],
            "idle_gaps": [[k, v / 1e6]
                          for k, v in list(trace.idle_by_host.items())[:top]]}

