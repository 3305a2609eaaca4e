"""xDeepFM's cell at a CPU's size: a sound run is correct, each planted
fault of the CIN comes out as not correct, and ``matmul_roofline_share``
reads a hand-made trace.

The faults (:data:`FAULTS`, planted through ``run_cell``'s ``plant``):
the CIN's second layer dropped, the halves of its first layer swapped
(layer 2 takes the maps that should be pooled), and its per-map bias left
out. ``python3 oebench/tests/test_oebench_xdeepfm.py --seed <n>`` plants
each on the card at the real cell's size and prints the numbers beside
their limits.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from oebench import peaks  # noqa: E402
from oebench.harness import run_cell  # noqa: E402
from oebench.layout import Bench  # noqa: E402
from oebench.trace import reduce_trace  # noqa: E402

CELL = "xdeepfm_dim64.zipf"
# the cell cut to a CPU's size; the CIN keeps the default (128, 128) the
# program builds
TINY = {"num_features": 4, "embedding_dim": 4, "dnn_units": [8, 4],
        "batch_size": 32, "vocab_sizes": [64, 5, 48, 64]}
# as the other tiny cells' limits (conftest.py); sound CPU runs of this
# cell read under 1e-6
TINY_LIMITS = {"loss_gap": 1e-6, "grad_gap": 1e-4, "change_gap": 1e-5}


def make_root(root: str) -> str:
    """A benchmark under ``root`` holding this cell alone, cut to
    :data:`TINY`, with a pool of 8 batches."""
    bench = Bench(REPO)
    for part in ("metrics", "distributions"):
        shutil.copytree(os.path.join(REPO, "oebench", part),
                        os.path.join(root, "oebench", part))
    cell = bench.workload(CELL)
    config = {**bench.config(cell["config"]), **TINY}
    mix = {**bench.traffic(cell["traffic"]), "pool_batches": 8}
    files = {f"configs/{cell['config']}.json": config,
             f"traffic/{cell['traffic']}.json": mix,
             f"limits/{CELL}.json": TINY_LIMITS}
    for rel, obj in files.items():
        path = os.path.join(root, "oebench", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
    spec = dict(bench.spec)
    spec["configs"] = [c for c in spec["configs"]
                       if c["name"] == cell["config"]]
    spec["workloads"] = [cell]
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if CELL in m.get("workloads", [CELL])]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _cin_forward(cin, x0, *, layers=None, swap=False, bias=True):
    """The CIN's forward with a fault: only the first ``layers`` layers
    (the others pool zeros), the halves of a split layer ``swap`` ped, or
    the filters without their ``bias``."""
    b, _f, d = x0.shape
    x0t = x0.transpose(1, 2)
    xk, pooled = x0t, []
    for k, h in enumerate(cin.sizes):
        split = cin.split_half and k < len(cin.sizes) - 1
        width = h // 2 if split else h
        if layers is not None and k >= layers:
            pooled.append(x0.new_zeros(b, width))
            continue
        conv = getattr(cin, f"conv_{k}")
        z = (xk[:, :, :, None] * x0t[:, :, None, :]).reshape(b * d, -1)
        maps = torch.relu(F.linear(z, conv.weight, conv.bias if bias
                                   else None)).reshape(b, d, h)
        if split:
            first, second = maps[..., :h // 2], maps[..., h // 2:]
            xk, direct = (second, first) if swap else (first, second)
        else:
            xk = direct = maps
        pooled.append(direct.sum(dim=1))
    return torch.cat(pooled, dim=-1)


def _planter(**fault):
    def plant(trainer):
        cin = trainer.module.CIN_0
        cin.forward = types.MethodType(
            lambda self, x0: _cin_forward(self, x0, **fault), cin)
    return plant


FAULTS = {"second_layer_dropped": _planter(layers=1),
          "halves_swapped": _planter(swap=True),
          "bias_left_out": _planter(bias=False)}


def _run(root, plant=None, trace=False, seed=2**31 + 77):
    return run_cell(Bench(root), CELL, seed, 0.2, trace, device="cpu",
                    started=time.time(), clock=time.time, plant=plant)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("xdeepfm")))


def test_a_sound_run_is_correct(root):
    result = _run(root, trace=True)
    assert result["correct"] is True, result["checks"]
    assert all(c["value"] <= 1e-6 for c in result["checks"].values())
    # on the CPU no kernel is named as a card's matrix product
    assert "matmul_roofline_share" not in result["metrics"]


def test_the_no_fault_planter_is_the_program(root):
    """:func:`_cin_forward` without a fault is the program's CIN, so each
    fault below differs from the program by its fault alone."""
    from openembedding_tpu_torch.models.deepctr import CIN
    cin = CIN(4, (128, 128))
    torch.manual_seed(0)
    with torch.no_grad():
        for p in cin.parameters():
            p.normal_(0.0, 0.1)
    x0 = torch.randn(8, 4, 4)
    assert torch.allclose(_cin_forward(cin, x0), cin(x0), rtol=1e-6,
                          atol=1e-7)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_cin_fault_is_not_correct(root, fault):
    result = _run(root, plant=FAULTS[fault])
    assert result["correct"] is False, (fault, result["checks"])


def _event(name, cat, ts, dur, corr=None):
    e = {"name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_matmul_roofline_share_on_a_hand_made_trace():
    """Two steps of 1 ms of matched kernels each (a CUTLASS sgemm, a gemv,
    a split-K reduction and a kernel named ``cin``), beside kernels whose
    names merely hold the letters: the share is the configuration's
    matrix-product time at the float32 peak over 1 ms."""
    bench = Bench(REPO)
    reader = bench.reader("matmul_roofline_share")
    events = [_event("oebench.traced_steps", "user_annotation", 0, 5000)]
    for step in range(2):
        t = 100 + 2000 * step
        events += [
            _event("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64>()",
                   "kernel", t, 600),
            _event("void gemv2T_kernel_val<int, int, float>()", "kernel",
                   t + 600, 100),
            _event("void splitKreduce_kernel<32, 16, int, float>()",
                   "kernel", t + 700, 100),
            _event("void ns::fused_cin_fwd<64>(float*)", "kernel", t + 800,
                   200),
            _event("void at::native::vectorized_elementwise_kernel<4>()",
                   "kernel", t + 1000, 300),
            _event("void ns::vaccine_kernel()", "kernel", t + 1300, 50),
            _event("Memcpy HtoD", "gpu_memcpy", t + 1400, 10),
        ]
    trace = reduce_trace(events, [0, 1])
    config = bench.config("xdeepfm_dim64")
    ctx = types.SimpleNamespace(config=config, trace=trace)
    from oebench.reference import xdeepfm
    want = 100.0 * xdeepfm.matmul_flops(config) / peaks.FP32_FLOPS / 1e-3
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)
    assert reader.kernel_names(trace) == sorted({
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64>()",
        "void gemv2T_kernel_val<int, int, float>()",
        "void splitKreduce_kernel<32, 16, int, float>()",
        "void ns::fused_cin_fwd<64>(float*)"})
    # the step's 482 GFLOP at 67 TFLOP/s take 7.2 ms: at 1 ms a step the
    # count or the time would be wrong, which the share shows above 100
    assert want > 100
    # nothing to read: no trace, no matched kernel, a model that counts
    # no matrix products
    assert reader.read(types.SimpleNamespace(config=config,
                                             trace=None)) is None
    bare = reduce_trace([e for e in events if "gemm" not in e["name"]
                         and "gemv" not in e["name"]
                         and "Kreduce" not in e["name"]
                         and "cin" not in e["name"]], [0, 1])
    assert reader.read(types.SimpleNamespace(config=config,
                                             trace=bare)) is None
    deepfm = bench.config("deepfm_dim9")
    assert reader.read(types.SimpleNamespace(config=deepfm,
                                             trace=trace)) is None


def main(argv=None) -> int:
    """Each fault planted at the real cell's size on the card: one JSON
    line a fault, its numbers beside the cell's limits."""
    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for name, plant in sorted(FAULTS.items()):
        result = run_cell(Bench(REPO), CELL, args.seed, args.seconds, False,
                          device="cuda:0", started=time.time(),
                          clock=time.time, plant=plant)
        print(json.dumps({"fault": name, "seed": args.seed,
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
