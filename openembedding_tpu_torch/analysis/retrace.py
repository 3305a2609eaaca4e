"""Retrace guard: a budget of step-program builds around a training loop
(``openembedding_tpu/analysis/retrace.py``).

A steady-state training loop should build nothing: every step replays
the step program built for its batch's columns, shapes and dtypes and
its state's tensors. A build per step (a shape wobble from an unpadded
last batch, a state replaced between steps) turns a replayed CUDA graph
back into a capture, a warm-up step and a replay. The guard makes that
mechanical: it counts the builds the ``Trainer`` reports over a scope
and fails when they exceed the declared budget. On CUDA a build is a
graph capture; on the CPU, the eager program's entry in the cache,
counted the same way so the budget can be tested there.

The JAX guard counts XLA compilations through ``jax.monitoring``; this
one counts :func:`note_build` calls, which ``training.Trainer`` makes
once per program it builds. The JAX module's ``compile_count`` and
``assert_no_recompiles`` measure ``jax.jit`` closures and have no
counterpart here.

Usage::

    with RetraceGuard(budget=0, name="steady-state loop"):
        for batch in batches:
            state, metrics = trainer.train_step(state, batch)

Nesting is supported; each guard counts every build that happens while
it is open (an inner guard's builds are also the outer one's).
"""

from __future__ import annotations

import threading
import warnings
from typing import List


class RetraceBudgetExceeded(RuntimeError):
    """More step-program builds happened inside the guard than budgeted."""


_lock = threading.Lock()
_active: List["RetraceGuard"] = []


def note_build() -> None:
    """One step program built: every open guard counts it."""
    with _lock:
        for guard in _active:
            guard._compiles += 1


class RetraceGuard:
    """Context manager failing when step-program builds exceed ``budget``.

    ``budget`` is the number of builds ALLOWED inside the scope (0 = a
    steady-state loop that must build nothing). ``on_exceed``: ``"raise"``
    (default) raises :class:`RetraceBudgetExceeded` on exit; ``"warn"``
    issues one ``RuntimeWarning`` and continues.
    """

    def __init__(self, budget: int = 0, *, name: str = "",
                 on_exceed: str = "raise"):
        if on_exceed not in ("raise", "warn"):
            raise ValueError(f"on_exceed must be 'raise' or 'warn', "
                             f"got {on_exceed!r}")
        self.budget = int(budget)
        self.name = name
        self.on_exceed = on_exceed
        self._compiles = 0
        self._entered = False

    @property
    def compiles(self) -> int:
        """Step-program builds observed so far inside this guard."""
        return self._compiles

    @property
    def exceeded(self) -> bool:
        return self._compiles > self.budget

    def __enter__(self) -> "RetraceGuard":
        if self._entered:
            raise RuntimeError("RetraceGuard is not reentrant; create a "
                               "new guard per scope")
        self._compiles = 0
        self._entered = True
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            if self in _active:
                _active.remove(self)
        self._entered = False
        if exc_type is not None:
            return False            # the original error is the story
        if self.exceeded:
            label = f" [{self.name}]" if self.name else ""
            msg = (f"retrace budget exceeded{label}: {self._compiles} "
                   f"step-program build(s) > budget {self.budget} — "
                   "something in the loop rebuilds per step (shape "
                   "wobble, a new column set, or a state whose tensors "
                   "were replaced)")
            if self.on_exceed == "raise":
                raise RetraceBudgetExceeded(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return False
