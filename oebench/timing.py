"""The measured window's clock.

On a CUDA device each step is closed by an event recorded on the current
stream; the events are read only once the window has closed, so the
window holds no synchronization of its own. Step ``i``'s time is the
interval from the event before it (the window's start event for the
first) to its own: the time the device took to get through that step,
whether it waited for the host or the host waited for it. The window's
wall time is the host's clock from its start, taken with the device idle,
to the end of the last step on the device.

Without a CUDA device (the benchmark's own tests) the host's clock stands
in for the events.
"""

from __future__ import annotations

import math
import time
from typing import List

import torch


class StepTimer:

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []
        self.t0 = self.t1 = None

    def _event(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self) -> float:
        """Open the window with the device idle; returns the host time."""
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.first = self._event()
        return self.t0

    def elapsed(self) -> float:
        """Host seconds since the window opened."""
        return time.perf_counter() - self.t0

    def mark(self) -> None:
        """Close a step."""
        self.marks.append(self._event())

    def stop(self) -> float:
        """Close the window once the device has finished; returns its wall
        seconds."""
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        return self.t1 - self.t0

    @property
    def steps(self) -> int:
        return len(self.marks)

    def step_ms(self) -> List[float]:
        """Every step's time, in milliseconds."""
        prev, out = self.first, []
        for e in self.marks:
            out.append(prev.elapsed_time(e) if self.cuda
                       else (e - prev) * 1e3)
            prev = e
        return out


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` percent of the values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]
