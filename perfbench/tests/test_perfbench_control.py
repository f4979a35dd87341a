"""The control: the reference put in the program's place and computed from
fp8 operands (the precision below the configuration's bf16) has to come out
not correct.  On the CPU at a tiny size, against the fixture cell's limits;
on the card (``gpu``) at each cell's own size on three seeds, against its
limits, as ``calibrate.py`` reads it."""

import json
import os

import pytest

from conftest import ROOT
from perfbench import calibrate, spec


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_is_not_correct_at_a_tiny_size(bench_root, seed):
    import torch
    numbers = calibrate.train_control(bench_root, "tiny.train", seed,
                                      torch.device("cpu"))
    assert _fails(numbers, spec.load(bench_root, "tiny.train")
                  .limits["limits"]), numbers


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cells' "
                    "own sizes")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_control_is_not_correct_at_each_cells_size(card):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        cell = spec.load(ROOT, name)
        limits = cell.limits["limits"]
        for seed in (9001, 9002, 9003):
            if cell.traffic["driver"] == "train":
                numbers = calibrate.train_control(ROOT, name, seed, card)
            else:
                got = calibrate.program_numbers(ROOT, name, seed, 40.0, card,
                                                control=True)
                numbers = {"logit_gap": got["control_logit_gap"]}
            assert _fails(numbers, limits), (name, seed, numbers)
