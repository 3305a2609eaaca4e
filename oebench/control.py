"""The control and a planted fault, read at a cell's own size.

    python3 -m oebench.control --workload <name> --seeds <n> [<n> ...]

For each seed it draws the cell's pool and initial values as a run does,
and holds to the float32 reference, by the numbers and limits of
``check.py``, two stand-ins put in the program's place:

* ``control``: the reference with its matrix products in TF32, the next
  precision below the configuration's float32 with TF32 off;
* ``half_batch``: the reference on the first half of each batch alone,
  the mean taken over that half (a planted fault).

A state left unchanged reads 1 by ``change_gap`` and needs no run. Each
reading is one JSON line; the benchmark's own runs never run this. Needs a
CUDA device (TF32 exists only there).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check
from .harness import draw_inputs, reference_readings
from .layout import Bench

STAND_INS = {"control": {"tf32": True}, "half_batch": {"half_batch": True}}


def readings(bench: Bench, workload: str, seed: int, device) -> dict:
    """Each stand-in's numbers and whether they pass the cell's limits."""
    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    pool, initial = draw_inputs(config, bench.traffic(cell["traffic"]),
                                seed, device)
    ref = reference_readings(config, pool, initial, device)
    limits = bench.limits(workload)
    out = {}
    for name, kwargs in STAND_INS.items():
        numbers = check.gaps(reference_readings(config, pool, initial,
                                                device, **kwargs), ref)
        ok, _ = check.judge(numbers, limits)
        out[name] = {"numbers": numbers, "correct": ok}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("oebench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(bench, args.workload, seed, "cuda:0")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
