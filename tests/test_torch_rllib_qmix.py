"""QMIX cooperative multi-agent learning, the port's mirror of
tests/test_rllib_qmix.py (reference: rllib/algorithms/qmix/qmix.py tested
on examples/env/two_step_game.py).

Protocol follows the QMIX paper: train under FULL exploration (eps=1),
evaluate the greedy joint policy.  The two-step game's optimum (8)
requires the first agent to pick the risky branch whose value only the
centralized (mixed, greedy-bootstrapped) critic sees; independent
Q-learning values that branch under a random partner (2.5 < 7) and
settles on the safe 7 — the credit-assignment gap the mixer closes.
The trainer runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import QMIXConfig


def _train(mixer: str, iters: int = 150, seed: int = 0) -> float:
    algo = (QMIXConfig().environment("TwoStepGame-v0")
            .training(mixer=mixer, epsilon_initial=1.0, epsilon_final=1.0,
                      lr=1e-3, target_network_update_freq=50)
            .resources(device="cpu")
            .debugging(seed=seed).build())
    for _ in range(iters):
        r = algo.step()
    assert np.isfinite(r["loss"])
    out = algo.greedy_episode_reward()
    algo.stop()
    return out


def test_qmix_mechanics_monotonic_mixer():
    """The mixing network is monotonic in every agent Q (abs weights):
    increasing any agent's Q never decreases Q_tot."""
    from ray_tpu_torch.rllib.qmix import mix, mixer_init
    mp = mixer_init(torch.Generator().manual_seed(0), n_agents=2,
                    state_dim=3, embed=8)
    state = torch.randn((16, 3), generator=torch.Generator().manual_seed(1))
    qs = torch.randn((16, 2), generator=torch.Generator().manual_seed(2))
    base = mix(mp, qs, state)
    for i in range(2):
        bumped = qs.clone()
        bumped[:, i] += 1.0
        assert bool(torch.all(mix(mp, bumped, state) >= base - 1e-5))


@pytest.mark.slow
def test_qmix_beats_independent_dqn_on_two_step_game():
    qmix = _train("qmix")
    iql = _train("none")
    assert qmix == 8.0, f"QMIX greedy={qmix} (paper-optimal is 8)"
    assert iql <= 7.0, f"independent-Q greedy={iql} (expected safe 7)"
    assert qmix > iql


@pytest.mark.slow
def test_vdn_mixer_settles_on_safe_branch():
    """VDN's state-independent additive mixer cannot represent the
    branch-dependent joint values (the paper's separation result)."""
    assert _train("vdn") <= 7.0
