"""Runs of fixture cells on the CPU through the harness, past its look for a
card: discovery by files alone, sound runs correct, and each fault a cell
can have, planted in the timed path, makes ``correct`` false."""

import json
import os

import pytest

from conftest import FIXTURE_METRIC, run_cpu
from perfbench import calibrate, spec


def test_fixture_cell_and_metric_are_found_as_files(bench_root):
    cell = spec.load(bench_root, "tiny.train")
    assert cell.traffic["driver"] == "train"
    assert FIXTURE_METRIC in [m["name"] for m in cell.end_to_end]
    result = run_cpu(bench_root, "tiny.train")
    assert result["correct"], result["checks"]
    assert result["metrics"][FIXTURE_METRIC]["value"] > 0
    assert result["metrics"]["train_tokens_per_s"]["unit"] == "tokens/s"
    assert list(result)[-1] == "checks"


def test_the_real_cells_load(bench_root):
    with open(os.path.join(bench_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load(bench_root, w["name"])
        spec.module(cell.base, "drivers", cell.traffic["driver"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.module(cell.base, "metrics", m["name"]).read)


@pytest.mark.parametrize("cell", ["tiny-moe.train", "tiny.closed"])
def test_sound_runs_are_correct(bench_root, cell):
    result = run_cpu(bench_root, cell, seed=2**31 + 11)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell, fault", [
    ("tiny.train", "unchanged"), ("tiny.train", "half"),
    ("tiny-moe.train", "half"), ("tiny.closed", "token")])
def test_a_planted_fault_is_not_correct(bench_root, cell, fault,
                                        monkeypatch):
    c = spec.load(bench_root, cell)
    driver = spec.module(c.base, "drivers", c.traffic["driver"])
    monkeypatch.setattr(calibrate, "TOKEN_EVERY", 1)
    with calibrate.FAULTS[fault](driver):
        result = run_cpu(bench_root, cell)
    assert not result["correct"], result["checks"]
