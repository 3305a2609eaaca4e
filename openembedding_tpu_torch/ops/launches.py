"""Launch counts of the kernel wrappers, kept true under CUDA graphs.

Each wrapper of a hand-written kernel (``gather_rows``, ``probe_gather``,
``init_rows``, ``init_flat``, ``find_or_insert``) keeps a plain integer
``launches`` and calls :func:`count` where it launches its kernels. A
launch made while the current stream is capturing does not run then: it
runs each time the graph replays. So :func:`count` adds it to the tally
of the capture in progress (:meth:`CountedGraph.capture`), and
:meth:`CountedGraph.replay` adds that tally to the counters on every
replay. A wrapper called while a stream captures outside a
``CountedGraph`` raises: its launches could not be counted.

A capture holds Python's cyclic garbage collector off (:func:`gc_held`):
a collection on the capturing thread can free an unreachable CUDA graph
of an earlier program, and destroying a graph while the thread captures
invalidates the capture.

Nothing here touches CUDA at import.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, List

import torch

_local = threading.local()      # .tallies: this thread's captures in progress
_gc_lock = threading.Lock()
_gc_holds = 0                   # captures in progress, every thread
_gc_was_enabled = False         # the collector's state before the first


def _tallies() -> List[Dict[Callable, int]]:
    tallies = getattr(_local, "tallies", None)
    if tallies is None:
        tallies = _local.tallies = []
    return tallies


def count(wrapper: Callable, kernels: int = 1) -> None:
    """``kernels`` launches of ``wrapper``'s kernels on the current CUDA
    stream."""
    if torch.cuda.is_current_stream_capturing():
        tallies = _tallies()
        if not tallies:
            raise RuntimeError(
                f"{wrapper.__name__} launched into a CUDA graph captured "
                "outside ops.launches.CountedGraph, whose replays would go "
                "uncounted")
        tally = tallies[-1]
        tally[wrapper] = tally.get(wrapper, 0) + kernels
        return
    wrapper.launches += kernels


@contextlib.contextmanager
def gc_held():
    """No cyclic garbage collection in the ``with`` body, on any thread;
    nested and concurrent holds restore the collector's state when the
    last one ends."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the kernel launches
    it holds. ``tally`` maps each wrapper to its launches in one replay."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.tally: Dict[Callable, int] = {}

    @contextlib.contextmanager
    def capture(self, pool=None):
        """Capture the CUDA work of the ``with`` body (``torch.cuda.graph``
        on its side stream, into the memory ``pool`` if one is given).
        Errors only for unsafe calls of this thread, so a server thread
        of the same process may go on using the card. The garbage
        collector is held off meanwhile (:func:`gc_held`)."""
        tallies = _tallies()
        tallies.append(self.tally)
        try:
            with gc_held(), torch.cuda.graph(
                    self.graph, pool=pool, capture_error_mode="thread_local"):
                yield self
        finally:
            tallies.remove(self.tally)

    def replay(self) -> None:
        """Launch the graph on the current stream; every wrapper's count
        moves by its launches in the graph."""
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n
