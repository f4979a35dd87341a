"""The port's runtime on the card: chip_smoke.py's runtime phase at a
small depth (GPT-2 at 2 layers, width 768, [2, 1024] tokens).

A ``num_gpus=1`` actor takes the params through the object store, runs
the bf16 forward on the flash kernel and hands its CUDA logits back; they
equal the in-process forward's (bit for bit, else within its bf16 error);
the observers see it (the actors channel, list_actors, list_tasks, the
timeline, spans, autotune_totals); a second one-card actor waits for the
first; a task without a card gets the logits as an equal CPU tensor.  Then
a one-card actor survives its node's death on a cluster_utils.Cluster
(the runtime_node_death step).  Serve on the card: an LLMServer replica
with num_gpus=1 streams over HTTP what an in-process engine gives, and a
serve-batched flash forward matches the in-process one (the
runtime_serve step, at a short engine).  Train on the card: a num_gpus=1
TorchTrainer worker SIGKILLed mid-run resumes bit-identically (the
runtime_train step).  The tests need a CUDA card and skip
without one.  It imports nothing of JAX, so on the card it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_runtime_gpu.py
"""

import dataclasses
import os
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import (GPTConfig, gpt_init, params_from_jax,
                                  params_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_runtime_gpu.py`")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)       # chip_smoke.py; workers inherit it
    import chip_smoke
    return chip_smoke


def _two_layers():
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), num_layers=2,
                              dtype=torch.bfloat16, attention="flash")
    tree = params_to_numpy(gpt_init(0, cfg, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen)
    return cfg, tree, tokens


@pytest.fixture
def card_cluster():
    chip_smoke = _chip_smoke()
    if chip_smoke.shm_free_bytes() < chip_smoke.RUNTIME_STORE_BYTES:
        pytest.fail(f"/dev/shm holds less than the "
                    f"{chip_smoke.RUNTIME_STORE_BYTES}-byte store")
    info = ray_tpu_torch.init(
        num_cpus=4, object_store_memory=chip_smoke.RUNTIME_STORE_BYTES)
    yield chip_smoke, info
    ray_tpu_torch.shutdown()


@pytest.mark.gpu
def test_gpt_forward_in_a_gpu_actor_through_the_store(card_cluster):
    chip_smoke, _ = card_cluster
    assert ray_tpu_torch.cluster_resources()["GPU"] >= 1.0
    cfg, tree, tokens = _two_layers()
    out = chip_smoke.runtime_steps(torch.device("cuda", 0), cfg, tree,
                                   tokens)
    assert out["actor_launches"] == (2 * out["actor_forwards"], 0, 0, 0, 0,
                                     0)
    assert out["bit_identical"] or (out["max_abs_diff_vs_in_process"] <=
                                    out["limit"])
    assert out["observe"]["actors_channel"][:1] == ["alive"]
    assert out["observe"]["list_tasks_forward"] == 3


@pytest.mark.gpu
def test_gpu_actor_survives_its_nodes_death():
    chip_smoke = _chip_smoke()
    cfg, tree, tokens = _two_layers()
    out = chip_smoke.runtime_node_death(torch.device("cuda", 0), cfg, tree,
                                        tokens)
    assert out["bit_identical_after_restart"]
    assert out["actor_launches"] == (4, 0, 0, 0, 0, 0)
    assert not set(out["card_apps_after_kill"]) & set(out["dead_pids"])


@pytest.mark.gpu
def test_gpu_actor_params_land_on_its_card(card_cluster):
    _, _ = card_cluster
    cfg = GPTConfig.tiny(vocab=128, seq=64)
    tree = params_to_numpy(gpt_init(0, cfg, device="cpu"))

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def __init__(self, tree):
            self.params = params_from_jax(tree, cfg)

        def where(self):
            return (os.environ["CUDA_VISIBLE_DEVICES"],
                    str(self.params["wte"].device),
                    self.params["wte"].float().sum().item())

    h = Holder.remote(ray_tpu_torch.put(tree))
    visible, device, total = ray_tpu_torch.get(h.where.remote(), timeout=300)
    assert visible == os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    assert device == "cuda:0"
    assert total == pytest.approx(float(tree["wte"].sum()), rel=1e-5)
    ray_tpu_torch.kill(h)


@pytest.mark.gpu
def test_serve_from_a_gpu_replica(card_cluster):
    chip_smoke, info = card_cluster
    cfg, tree, tokens = _two_layers()
    dev = torch.device("cuda", 0)
    # The limit the runtime phase uses: the in-process bf16-against-f32
    # error of the forward.
    limit = chip_smoke.in_process_forward(dev, cfg, tree, tokens)[2]
    serve_cfg = dict(chip_smoke.SERVE, max_prompt=128, max_new=16)
    out = chip_smoke.runtime_serve(dev, cfg, tree, info["dashboard_address"],
                                   limit, serve_cfg=serve_cfg)
    assert out["http"]["streams"] == 12
    assert out["api_serve"]["llm"]["running"] == 1
    assert out["flash_launches"] == (
        2 * len(out["flash_batch_sizes"]), 0, 0, 0, 0, 0)
    assert out["flash_max_abs_diff_vs_in_process"] <= limit


@pytest.mark.gpu
def test_train_and_resume_in_a_gpu_trainer(card_cluster):
    """The runtime_train step at 2 layers: a control fit and a fit whose
    num_gpus=1 worker is SIGKILLed after step 9 and recovered from step
    8's checkpoint; the same losses and params, bit for bit."""
    chip_smoke, _ = card_cluster
    cfg = dataclasses.replace(
        GPTConfig.gpt2_small(), num_layers=2, dtype=torch.bfloat16,
        attention="flash", remat=True, remat_policy="dots", ce_block=256)
    out = chip_smoke.runtime_train(torch.device("cuda", 0), cfg)
    assert out["resume_bit_identical"]
    assert out["recovery"]["incarnations"] == 2
    # 13 steps ran in the recovery's two workers and 12 in the control's.
    assert out["launches"] == (4 * 25, 2 * 25, 2 * 25, 0, 0, 0)
