"""Run one cell of the benchmark once and print its result.

    python3 -m oebench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``oebench/``
and ``openembedding_tpu_torch/``. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit. The same numbers
are the last lines of standard error.

The run exits with another code than 0, and prints no result, without a
CUDA device, with fewer devices than the cell asks for, or when a module
of JAX or of the JAX package has been loaded by the time the window has
closed. Build and kernel caches stay inside the checkout: the port keeps
its nvcc libraries in ``openembedding_tpu_torch/_build/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` default to
``.oebench_cache/`` there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "openembedding_tpu")


def process_start_epoch() -> float:
    """The process's start, in seconds since the epoch: from ``/proc`` on
    Linux (clock ticks since boot, plus the boot time), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


STARTED = process_start_epoch()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, flax's, optax's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, ".oebench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from .harness import run_cell
    from .layout import Bench
    bench = Bench(root)
    chips = int(bench.workload(args.workload)["chips"])
    if not torch.cuda.is_available():
        print("oebench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"oebench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda:0", started=STARTED,
                      clock=time.time)
    found = forbidden_modules()
    if found:
        print(f"oebench: loaded {found}, which the benchmark must not",
              file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
