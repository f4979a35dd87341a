"""Client-server RL: PolicyServerInput / PolicyClient, the port's mirror
of tests/test_rllib_policy_server.py.

Reference shape: ``rllib/env/policy_server_input.py`` +
``rllib/env/policy_client.py`` — an external simulator process drives
episodes against a TCP policy server; the logged experience becomes the
learner's train batches.  The slow test runs REAL external OS processes
(subprocesses) playing CartPole through the server until PPO clears a
reward threshold.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.policy_server import PolicyClient
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, OBS,
                                              VALUE_TARGETS)


def _make_algo(**training):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, input="policy_server",
                      policy_server_port=0, rollout_fragment_length=64)
            .training(**training)
            .resources(device="cpu")
            .debugging(seed=0).build())


def test_policy_server_protocol_and_batch():
    algo = _make_algo()
    addr = algo.workers.server_input.address
    client = PolicyClient(addr)

    # drive two short fake episodes from this (client) side
    for terminated in (True, False):
        eid = client.start_episode()
        obs = np.zeros(4, np.float32)
        for t in range(70):
            a = client.get_action(eid, obs)
            assert a in (0, 1)
            client.log_returns(eid, 1.0)
        client.end_episode(eid, obs, truncated=not terminated)

    batch = algo.workers.server_input.sample(timeout=30)
    assert batch.count == 140
    assert batch[OBS].shape == (140, 4)
    assert set(np.unique(batch[ACTIONS])) <= {0, 1}
    assert np.isfinite(batch[ADVANTAGES]).all()
    assert np.isfinite(batch[VALUE_TARGETS]).all()
    m = algo.workers.server_input.get_metrics()
    assert m["episode_rewards"] == [70.0, 70.0]
    client.close()
    algo.stop()


CLIENT_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from ray_tpu_torch.rllib.env import CartPoleVectorEnv
    from ray_tpu_torch.rllib.policy_server import PolicyClient

    addr, seed = sys.argv[1], int(sys.argv[2])
    client = PolicyClient(addr)
    env = CartPoleVectorEnv(1, seed=seed)
    obs = env.vector_reset(seed=seed)
    eid = client.start_episode()
    steps = 0
    while True:
        a = client.get_action(eid, obs[0])
        obs, rew, done, info = env.vector_step(np.array([a]))
        client.log_returns(eid, float(rew[0]))
        steps += 1
        if done[0]:
            truncated = bool(info["truncated"][0])
            client.end_episode(eid, info["terminal_obs"][0],
                               truncated=truncated)
            eid = client.start_episode()
""")


@pytest.mark.slow
def test_external_process_drives_cartpole_to_learning_threshold():
    """Two external OS processes play CartPole through the TCP server;
    PPO on the server side must clear a 150-reward bar (random ~20)."""
    algo = _make_algo(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=128,
                      entropy_coeff=0.005)
    addr = algo.workers.server_input.address
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLIENT_SCRIPT, addr, str(i)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for i in range(2)]
    try:
        best = 0.0
        for _ in range(200):
            r = algo.train()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best >= 150.0:
                break
        assert best >= 150.0, f"client-server PPO best={best}"
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        algo.stop()
