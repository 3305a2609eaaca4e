"""The control and the planted fault at each cell's own size: they have to
come out as not correct. Needs the card (TF32 exists only there); skips
without one."""

from __future__ import annotations

import pytest
import torch

from conftest import REPO

from oebench import control
from oebench.layout import Bench

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["deepfm_dim9.uniform",
                                  "deepfm_dim9_hash.zipf",
                                  "deepfm_dim9.zipf"])
def test_control_and_fault_are_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    bench = Bench(REPO)
    for seed in SEEDS:
        got = control.readings(bench, cell, seed, "cuda:0")
        assert got["control"]["correct"] is False, (seed, got)
        assert got["half_batch"]["correct"] is False, (seed, got)
