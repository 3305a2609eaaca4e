"""The program's own timings of its train step's host phases, as the
per-layer metrics of those phases read them: ``openembedding_tpu_torch.
utils.observability.step_timings()``, once the windows have closed.

Host phases (``step``, ``copy`` with its wait for the card, ``launch``):
``Trainer.train_step``'s clock readings, over the steps the program
counts (neither a build nor a step under the profiler: the checked steps
after the first, the warm-up and the untraced window); milliseconds a
step. Each returns None where
the program records nothing: a program without step timings, or a phase
it never counted.
"""

from __future__ import annotations

from typing import Optional


def timings() -> Optional[dict]:
    try:
        from openembedding_tpu_torch.utils import observability
    except ImportError:
        return None
    read = getattr(observability, "step_timings", None)
    return None if read is None else read()


def host_ms(ctx, phase: str) -> Optional[float]:
    """Host milliseconds a counted step of ``phase``."""
    del ctx
    got = timings()
    entry = None if got is None else got["host"].get(phase)
    if not entry or not entry["calls"]:
        return None
    return 1e3 * entry["seconds"] / entry["calls"]
