"""RLlib and the card as a resource, with a fake card (no card present).

* The remote rollout workers of a PPO are card-less actors: they hold no
  card and see ``CUDA_VISIBLE_DEVICES=""`` (``WorkerSet`` builds them with
  ``device="cpu"`` and ``num_cpus`` only).
* Ape-X's rollout workers and replay shards are card-less too.
* ``PPO.default_resource_request({})`` asks for the learner's card, as the
  trial runner calls it; ``device="cpu"`` asks for none, nor does ES.  So
  do ``ApexDQN``'s and, outside ``Algorithm``, ``MultiAgentPPO``'s and
  ``QMIX``'s.
* A ``Tuner(PPO)`` trial leases the card for its actor and gives it back
  after its stop.
* The purity rule (``test_torch_gpu_resources.py``): no process of an
  RLlib cluster -- the driver, the rollout workers, Ape-X's replay
  shards, the trial actors -- imports JAX or anything of ``ray_tpu``.

This module imports neither: the cluster's workers import it.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.air import RunConfig
from ray_tpu_torch.rllib import (ApexDQN, ApexDQNConfig, ESConfig,
                                 MultiAgentPPO, PPO, PPOConfig, QMIX,
                                 WorkerSet)
from ray_tpu_torch.tune import TuneConfig, Tuner
from test_torch_gpu_resources import _FORBIDDEN_IMPORT, _driver, _imports


@pytest.fixture(scope="module")
def gpu_cluster():
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    yield
    ray_tpu_torch.shutdown()


def _wait_card_free(timeout=60):
    deadline = time.monotonic() + timeout
    while ray_tpu_torch.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, (
            "the card never came back", ray_tpu_torch.available_resources())
        time.sleep(0.1)


def _ppo_config(workers=2):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=workers, num_envs_per_worker=2,
                      rollout_fragment_length=8)
            .resources(device="cpu"))


def test_rollout_workers_hold_no_card(gpu_cluster):
    ws = WorkerSet(_ppo_config().to_dict())
    try:
        seen = ws.foreach_worker(
            lambda w: (os.environ.get("CUDA_VISIBLE_DEVICES"),
                       str(w.policy.device)))
        assert seen[1:] == [("", "cpu"), ("", "cpu")], seen
        assert ray_tpu_torch.available_resources().get("GPU") == 1.0
        assert ws.synchronous_sample().count == 2 * 2 * 8
    finally:
        ws.stop()


def test_apex_workers_and_shards_hold_no_card(gpu_cluster):
    _wait_card_free()
    algo = (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                      rollout_fragment_length=4)
            .training(learning_starts=32, train_batch_size=16,
                      num_train_iters=2, num_replay_shards=2)
            .resources(device="cpu").build())
    try:
        r = algo.train()
        assert r["num_updates"] == 2
        seen = algo.workers.foreach_worker(
            lambda w: (os.environ.get("CUDA_VISIBLE_DEVICES"),
                       str(w.policy.device)))
        assert seen[1:] == [("", "cpu"), ("", "cpu")], seen
        shards = ray_tpu_torch.get([s.visible_cards.remote()
                                    for s in algo.replay_shards], timeout=60)
        assert shards == ["", ""], shards
        assert ray_tpu_torch.available_resources().get("GPU") == 1.0
    finally:
        algo.stop()


def test_default_resource_request_asks_for_the_learner_card():
    assert PPO.default_resource_request({}) == {"CPU": 1.0, "GPU": 1.0}
    cfg = PPOConfig().rollouts(num_rollout_workers=2).to_dict()
    assert PPO.default_resource_request(cfg) == {"CPU": 3.0, "GPU": 1.0}
    cfg = PPOConfig().resources(num_learner_devices=2).to_dict()
    assert PPO.default_resource_request(cfg)["GPU"] == 2.0
    assert "GPU" not in PPO.default_resource_request(
        _ppo_config().to_dict())
    assert "GPU" not in ESConfig().algo_class.default_resource_request(
        ESConfig().to_dict())
    for cls in (ApexDQN, MultiAgentPPO, QMIX):
        assert cls.default_resource_request({})["GPU"] == 1.0, cls
        assert "GPU" not in cls.default_resource_request(
            {"device": "cpu"}), cls


class _CardPPO(PPO):
    """PPO whose results say which cards its trial actor was leased."""

    def step(self):
        result = super().step()
        result["cards"] = os.environ.get("CUDA_VISIBLE_DEVICES")
        return result


def test_tuned_ppo_trial_leases_the_card_and_gives_it_back(gpu_cluster):
    _wait_card_free()
    config = _ppo_config(workers=0).to_dict()
    results = Tuner(
        _CardPPO, param_space=config,
        tune_config=TuneConfig(metric="episode_reward_mean", mode="max"),
        run_config=RunConfig(stop={"training_iteration": 2})).fit()
    assert not results.errors, results.errors
    assert [r.metrics["cards"] for r in results] == ["0"]
    assert [r.metrics["training_iteration"] for r in results] == [2]
    _wait_card_free()


def test_no_process_of_an_rllib_cluster_imports_jax_or_ray_tpu(tmp_path):
    """A PPO with two rollout workers, an Ape-X DQN with two workers and
    two replay shards, and a Tuner(PPO) trial on one cluster; the helpers
    and the forbidden pattern are test_torch_gpu_resources.py's."""
    code = """
import os
import ray_tpu_torch as rt
from ray_tpu_torch.air import RunConfig
from ray_tpu_torch.rllib import ApexDQNConfig, PPO, PPOConfig
from ray_tpu_torch.tune import TuneConfig, Tuner
rt.init(num_cpus=4)
cfg = (PPOConfig().environment("CartPole-v1")
       .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                 rollout_fragment_length=8)
       .resources(device="cpu"))
algo = cfg.build()
r = algo.train()
cards = algo.workers.foreach_worker(
    lambda w: os.environ.get("CUDA_VISIBLE_DEVICES"))[1:]
algo.stop()
apex = (ApexDQNConfig().environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                  rollout_fragment_length=4)
        .training(learning_starts=32, train_batch_size=16,
                  num_train_iters=2)
        .resources(device="cpu").build())
updates = apex.train()["num_updates"]
apex.stop()
results = Tuner(PPO, param_space=cfg.rollouts(num_rollout_workers=0)
                .to_dict(),
                tune_config=TuneConfig(metric="episode_reward_mean",
                                       mode="max"),
                run_config=RunConfig(stop={"training_iteration": 1})).fit()
assert not results.errors, results.errors
print("RESULT", cards, r["num_env_steps_sampled"], updates)
rt.shutdown()
"""
    proc = _driver(code, {"RT_NUM_GPUS": "1", "PYTHONPROFILEIMPORTTIME": "1",
                          "RT_LOG_DIR": str(tmp_path)}, timeout=180)
    assert "RESULT ['', ''] 32 2" in proc.stdout, proc.stdout
    logs = {p.name: p.read_text() for p in tmp_path.iterdir()
            if p.suffix in (".err", ".log")}
    workers = [v for k, v in logs.items() if k.startswith("worker-")]
    # Four rollout workers and a trial actor at least, each importing the
    # RLlib modules itself, and the two replay shards.
    assert sum("ray_tpu_torch.rllib.rollout_worker" in _imports(t)
               for t in workers) >= 5
    assert sum("ray_tpu_torch.rllib.apex_dqn" in _imports(t)
               for t in workers) >= 2
    assert "ray_tpu_torch.rllib" in _imports(proc.stderr)
    for name, text in [("driver+daemon", proc.stderr)] + sorted(
            logs.items()):
        mods = _imports(text)
        bad = [m for m in mods if _FORBIDDEN_IMPORT.search("| " + m)]
        assert not bad, (name, bad)
