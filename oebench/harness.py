"""One run of one cell.

In order: build the configuration's trainer through the program's entry
points; draw the pool of host batches and the initial values from the
seed; take three steps through ``Trainer.train_step`` on the pool's first
three batches, reading the state after the first and the third (the
checked steps); warm up on the following batches; measure for
``seconds``; with ``trace``, trace a further window of steps; read the
device's peak memory; free the program; run the plain reference over the
three checked batches and compare.

The set-up time runs from the process's start to the first timed step.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, peaks, program, traffic
from .initial import Initial
from .layout import Bench
from .reference import train as reference
from .reference.mapping import vocab_sizes, vocabulary_keys
from .timing import StepTimer, percentile
from .trace import Trace, breakdown, traced_window

CHECKED_STEPS = 3
WARMUP_STEPS = 20
TRACE_SECONDS = 0.5      # the traced window, at the untraced window's pace
TRACE_MIN_STEPS = 20


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    config: dict
    pool: traffic.RawPool        # the raw batches
    batches: List[dict]          # the program's host batches
    steps: int                   # steps of the untraced window
    window_s: float              # its wall time
    trace: Optional[Trace]
    state: object                # the program's state after the windows


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def draw_inputs(config: dict, mix: dict, seed: int, device,
                find=traffic.load_distribution):
    """The pool of raw batches and the initial values of a run, from the
    seed; a hash cell's keys are every key of the configuration's
    vocabulary, which the table holds before the first step."""
    pool = traffic.make_pool(mix, config, seed, device, find)
    if len(pool) < CHECKED_STEPS + 1:
        raise ValueError("the pool must hold more batches than the checked "
                         "steps")
    keys = None
    if config["table"] == "hash":
        keys = vocabulary_keys(vocab_sizes(config), device)
    return pool, Initial(config, seed, device, keys)


def reference_readings(config: dict, pool, initial, device,
                       **kwargs) -> Dict:
    """The reference's readings over the checked batches."""
    n = range(CHECKED_STEPS)
    return reference.run(config, [pool.ids[t] for t in n],
                         [pool.dense[t] for t in n],
                         [pool.label[t] for t in n], initial, device,
                         **kwargs)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, *, device, started: float, clock: Callable,
             plant: Optional[Callable] = None) -> Dict:
    """Run ``workload`` once; returns the result's fields (``checks``
    last). ``started``: the process's start on ``clock``'s scale.
    ``plant``: called with the built trainer before any step (the
    benchmark's own tests plant faults with it)."""
    device = torch.device(device)
    stamps = [("process", started), ("imports", clock())]
    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    readers = bench.readers(workload) if trace else {}
    # the program runs at the precision the configuration states
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])

    trainer, mapper = program.build(config, device)
    if plant is not None:
        plant(trainer)
    stamps.append(("build", clock()))
    pool, initial = draw_inputs(config, mix, seed, device,
                                bench.distribution)
    stamps.append(("traffic", clock()))
    batches = program.host_batches(pool, mapper, config)
    touched = [reference.touched_ids(config, pool.ids[t])
               for t in range(CHECKED_STEPS)]
    stamps.append(("fuse", clock()))
    state = program.init_state(trainer, initial, batches[0])
    _sync(device)
    stamps.append(("initial_state", clock()))

    def entries(sets):
        every = np.unique(np.concatenate([s.ravel() for s in sets]))
        return every if initial.keys is not None else every[every >= 0]

    losses = []
    for t in range(CHECKED_STEPS):
        state, out = trainer.train_step(state, batches[t])
        losses.append(out["loss"])
        if t == 0:
            readings = {"grad": program.grad_readings(
                state, initial, entries(touched[:1]))}
    readings["change"], readings["stray"] = program.change_readings(
        state, initial, entries(touched))
    readings["loss"] = [float(v) for v in losses]
    stamps.append(("checked_steps", clock()))
    index = CHECKED_STEPS
    for _ in range(WARMUP_STEPS):
        state, _ = trainer.train_step(state, batches[index % len(batches)])
        index += 1
    _sync(device)
    if device.type == "cuda":
        # the peak is the program's: its state and what the window's steps
        # allocate, not what the benchmark's set-up held for a while
        torch.cuda.reset_peak_memory_stats(device)

    timer = StepTimer(device)
    timer.start()
    stamps.append(("warmup", clock()))
    setup_s = stamps[-1][1] - started
    while True:
        state, _ = trainer.train_step(state, batches[index % len(batches)])
        timer.mark()
        index += 1
        if timer.elapsed() >= seconds:
            break
    window_s = timer.stop()
    step_ms = timer.step_ms()
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    traced = None
    if trace:
        steps = max(TRACE_MIN_STEPS,
                    round(TRACE_SECONDS * timer.steps / window_s))
        state, traced = traced_window(trainer, state, batches, index, steps)
    ctx = Context(config=config, pool=pool, batches=batches,
                  steps=timer.steps, window_s=window_s, trace=traced,
                  state=state)
    layer_values = {name: r.read(ctx) for name, r in readers.items()}
    del ctx, state, trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(config, pool, initial, device)
    correct, checks = check.judge(check.gaps(readings, ref), limits)

    examples = timer.steps * int(config["batch_size"])
    measured = {"examples_per_s": examples / window_s,
                "step_ms_p95": percentile(step_ms, 95),
                "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in bench.spec["end_to_end"]
             + bench.spec["per_layer"]}
    if trace:
        names = [m["name"] for m in bench.per_layer(workload)]
        values = {k: layer_values[k] for k in names
                  if layer_values[k] is not None}
    else:
        names = [m["name"] for m in bench.end_to_end(workload)]
        values = {k: measured[k] for k in names}
    result = {
        "correct": correct,
        "attempted": timer.steps,
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in values.items()},
        "device": _device(device, memory_peak, traced),
    }
    result["window"] = {"steps": timer.steps, "seconds": window_s,
                        "examples": examples,
                        "step_ms": 1e3 * window_s / timer.steps,
                        "step_ms_p50": percentile(step_ms, 50),
                        "step_ms_max": max(step_ms)}
    if traced is not None:
        result["breakdown"] = breakdown(traced)
        # the profiler's cost: the traced window's pace beside the
        # untraced one's
        result["window"]["traced_steps"] = traced.steps
        result["window"]["traced_step_ms"] = \
            traced.window_us / 1e3 / traced.steps
        result["window"]["traced_host_step_ms"] = \
            traced.host_window_us / 1e3 / traced.steps
        result["window"]["busy_step_ms"] = \
            traced.busy_us / 1e3 / traced.steps
    result["setup_stages_s"] = {b[0]: b[1] - a[1]
                                for a, b in zip(stamps, stamps[1:])}
    result["checks"] = checks
    return result


def _device(device, memory_peak: int, traced: Optional[Trace]) -> Dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if traced is not None:
        out["busy_s"] = traced.busy_us / 1e6
        out["window_s"] = traced.window_us / 1e6
        if device.type == "cuda":
            out["power_limit_w"] = peaks.power_limit_w()
    return out

