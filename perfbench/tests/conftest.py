"""Fixtures of the benchmark's CPU tests: a checkout of the benchmark in a
temp directory with tiny fixture configurations, mixes, limits and cells
added as files and entries alone, run on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "name": "tiny", "source": "a fixture", "activation_function": "gelu_new",
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "n_ctx": 128,
    "n_embd": 64, "n_head": 4, "n_inner": None, "n_layer": 2,
    "n_positions": 128, "vocab_size": 250, "reduced": [],
    "assumed": {"padded_vocab_size": 256},
    "train": {"dtype": "bfloat16", "attention": "flash",
              "remat_policy": "dots", "ce_block": 16,
              "learning_rate": 0.0003, "betas": [0.9, 0.95], "eps": 1e-08,
              "weight_decay": 0.0001},
    "serve": {"dtype": "bfloat16", "page_size": 8, "max_batch": 4,
              "num_pages": 65, "max_prompt_len": 64, "max_new_tokens": 64},
}
TINY_MOE = dict(copy.deepcopy(TINY), name="tiny-moe",
                moe={"num_experts": 4, "expert_top_k": 2,
                     "capacity_factor": 1.25, "aux_loss_coef": 0.01})
LAW = {"zipf": 1.1, "law_seed": 1}
LENGTHS = {"prompt_len": {"median": 24, "sigma": 0.8, "min": 4, "max": 64},
           "output_len": {"median": 12, "sigma": 0.6, "min": 2, "max": 24}}
TRAFFIC = {
    "train-tiny": {"driver": "train", "batch": 4, "seq": 64,
                   "token_law": LAW, "pool_batches": 4, "check_steps": 3,
                   "trace_steps": 1},
    "closed-tiny": dict(LENGTHS, driver="serve_closed", clients=8,
                        requests=64, sizes_seed=2, token_law=LAW,
                        check_requests=3, trace_seconds=1),
}
# Cells, with limits wide enough for bf16 against f32 at these sizes and
# far under what a planted fault reads.
CELLS = {
    "tiny.train": ("tiny", "train-tiny",
                   {"loss_gap": 0.01, "grad_gap": 0.004, "change_gap": 0.1}),
    "tiny-moe.train": ("tiny-moe", "train-tiny",
                       {"loss_gap": 0.01, "grad_gap": 0.2,
                        "change_gap": 0.2}),
    "tiny.closed": ("tiny", "closed-tiny", {"logit_gap": 0.05}),
}
FIXTURE_METRIC = "fixture_steps_per_s"


@pytest.fixture
def bench_root(tmp_path):
    return make_root(tmp_path)


def make_root(tmp_path):
    """A checkout holding the benchmark and the fixture cells in
    ``tmp_path``; returns its root."""
    base = tmp_path / "perfbench"
    shutil.copytree(os.path.join(ROOT, "perfbench"), base,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cfg in (TINY, TINY_MOE):
        (base / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "fixture",
                                 "file": f"perfbench/configs/"
                                         f"{cfg['name']}.json",
                                 "reduced": [], "why": "fixture"})
    for name, tr in TRAFFIC.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for cell, (config, tr, limits) in CELLS.items():
        (base / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": tr, "chips": 1,
                                   "why": "fixture"})
    (base / "metrics" / f"{FIXTURE_METRIC}.py").write_text(
        "def read(run):\n"
        "    return run['steps'] / run['window_s'] if 'steps' in run "
        "else None\n")
    bench["end_to_end"].append({"name": FIXTURE_METRIC, "unit": "steps/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.train",
                                              "tiny-moe.train"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"] += ["tiny.train", "tiny-moe.train"]
        if m["name"] in ("serve_tokens_per_s",):
            m["workloads"] += ["tiny.closed"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def run_cpu(root, cell, seed=7, seconds=1.0):
    """One run of a cell on the CPU, as ``run.py`` makes it past its look
    for a card."""
    import time
    import torch
    from perfbench import run
    return run.run_cell(root, cell, seed, seconds, False,
                        torch.device("cpu"), time.perf_counter())[0]
