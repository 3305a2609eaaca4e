"""The comparison that decides ``correct``.

Readings (of the program, or of the control in its place) are held to the
reference's by three numbers:

* ``loss_gap``: over the three steps, the largest of ``|loss - ref| /
  |ref|``;
* ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first step's gradient, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same for the change after three steps, with the
  program's change outside the rows the reference touched (``stray``,
  which must be nought) added to the gap. Leaves whose reference gradient
  is under a thousandth of the median leaf's move by round-off alone and
  are left out.

Each number has its limit (``limits/<workload>.json``); a run is correct
when every number is finite and within its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
QUIET_LEAF = 1e-3


def _worst(values) -> float:
    """The largest value; infinite if any is not a finite number."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    loss = _worst(abs(a - b) / abs(b)
                  for a, b in zip(program["loss"], reference["loss"]))
    if len(program["loss"]) != len(reference["loss"]):
        loss = math.inf
    ref_grad = reference["grad"]
    median = statistics.median(ref_grad.values())
    grad = _worst(abs(program["grad"][k] - g) / max(g, median)
                  for k, g in ref_grad.items())
    moved = [k for k, g in ref_grad.items() if g >= QUIET_LEAF * median]
    median_change = statistics.median(reference["change"][k] for k in moved)
    change = _worst((abs(program["change"][k] - reference["change"][k])
                     + program["stray"][k])
                    / max(reference["change"][k], median_change)
                    for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """Whether every number is finite and within its limit, and each
    number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": float(limits[k])}
              for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
