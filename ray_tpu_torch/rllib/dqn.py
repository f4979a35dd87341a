"""DQN: double Q-learning with a target network and prioritized replay.

Port of ``ray_tpu/rllib/dqn.py``.  Design analog: reference
``rllib/algorithms/dqn/dqn.py`` (training_step: sample fragments -> store
in replay -> N learner updates -> target sync) and ``dqn_torch_policy.py``
(double-DQN loss, per-row TD error feeding priority updates).  The
Q-update (the target network's forward included) runs on the policy's
device; its TD errors come back to the host as numpy in the same copy as
the loss, since the priorities are numpy.  Epsilon-greedy stays on the
policy's numpy generator, so the port's actions equal the JAX package's
wherever the greedy actions agree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (OptaxAdam, TorchPolicy, ac_init,
                                        head_forward, to_tensors,
                                        tree_leaves, tree_to_numpy,
                                        tree_unflatten, value_and_grad)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS, SampleBatch)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DQN)
        self._config.update({
            "policy": "dqn",
            "hiddens": (64, 64),
            "lr": 5e-4,
            "train_batch_size": 64,
            "buffer_size": 50_000,
            "learning_starts": 1000,
            "prioritized_replay": True,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
            "target_network_update_freq": 500,   # env steps
            "num_train_iters": 8,                # updates per training_step
            "double_q": True,
            "epsilon_initial": 1.0,
            "epsilon_final": 0.02,
            "epsilon_timesteps": 10_000,
            "rollout_fragment_length": 4,
            "num_envs_per_worker": 8,
            "gamma": 0.99,
        })


def dqn_device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """The columns the Q-update reads, on ``device``: f32 but for the
    actions (int64 indices) and the dones (bool); ``weights`` are the
    importance weights, ones without them."""
    n = len(batch[OBS])
    return to_tensors({
        OBS: np.asarray(batch[OBS], np.float32),
        NEXT_OBS: np.asarray(batch[NEXT_OBS], np.float32),
        ACTIONS: np.asarray(batch[ACTIONS], np.int64),
        REWARDS: np.asarray(batch[REWARDS], np.float32),
        DONES: np.asarray(batch[DONES], bool),
        "weights": np.asarray(batch.get("weights", np.ones(n)),
                              np.float32)}, device)


class DQNPolicy(TorchPolicy):
    """Q-network policy; ``replay_style`` makes workers collect raw
    transitions instead of GAE fragments."""

    replay_style = True

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        if action_space.kind != "discrete":
            raise ValueError("DQN requires a discrete action space")
        self._setup(action_space, config, seed)
        self.num_actions = action_space.n
        self._rng = np.random.default_rng(seed)
        self.params = ac_init(self._init_gen, obs_dim, self.num_actions,
                              tuple(config.get("hiddens", (64, 64))),
                              value_head=False, device=self.device)
        # Params are replaced, never changed in place: the target holds
        # the tensors of its time.
        self.target_params = self.params
        self._opt = OptaxAdam(tree_leaves(self.params),
                              config.get("lr", 5e-4))
        self._steps_seen = 0
        self._gamma = config.get("gamma", 0.99)
        self._double_q = config.get("double_q", True)
        # Exploration modules (reference rllib/utils/exploration/):
        # parameter-space noise replaces epsilon-greedy; RND curiosity
        # adds an intrinsic novelty bonus at learn time.
        self._param_noise = None
        if config.get("exploration") == "parameter_noise":
            from ray_tpu_torch.rllib.exploration import ParameterNoise
            self._param_noise = ParameterNoise(
                seed=seed,
                initial_sigma=config.get("param_noise_sigma", 0.05),
                target_divergence=config.get(
                    "param_noise_target", 0.1))
            self._noisy_params = self._param_noise.perturb(self.params)
            self._since_perturb = 0
        self._rnd = None
        if config.get("rnd_coeff", 0.0) > 0.0:
            from ray_tpu_torch.rllib.exploration import RNDCuriosity
            self._rnd = RNDCuriosity(obs_dim, seed=seed, device=self.device)

    @torch.no_grad()
    def _greedy(self, params, obs: torch.Tensor) -> np.ndarray:
        return head_forward(params, obs).argmax(dim=1).cpu().numpy()

    def _loss(self, params, b):
        q = head_forward(params, b[OBS])
        q_sel = torch.gather(q, 1, b[ACTIONS][:, None])[:, 0]
        with torch.no_grad():
            q_next_t = head_forward(self.target_params, b[NEXT_OBS])
            if self._double_q:
                best = torch.argmax(head_forward(params, b[NEXT_OBS]), dim=1)
            else:
                best = torch.argmax(q_next_t, dim=1)
            q_next = torch.gather(q_next_t, 1, best[:, None])[:, 0]
            target = b[REWARDS] + self._gamma * (
                1.0 - b[DONES].to(torch.float32)) * q_next
        td = q_sel - target
        # Huber on weighted TD errors (priority-corrected): the weights
        # scale each row before the mean.
        abs_td = torch.abs(td)
        loss = torch.mean(b["weights"] * torch.where(
            abs_td < 1.0, 0.5 * td ** 2, abs_td - 0.5))
        return loss, {"loss": loss, "abs_td": abs_td}

    # -- rollout side -----------------------------------------------------

    def _epsilon_at(self, global_steps: int) -> float:
        c = self.config
        frac = min(1.0, global_steps /
                   max(1, c.get("epsilon_timesteps", 10_000)))
        return c.get("epsilon_initial", 1.0) + frac * (
            c.get("epsilon_final", 0.02) - c.get("epsilon_initial", 1.0))

    def _epsilon(self) -> float:
        # epsilon_timesteps is a GLOBAL env-step budget: with N samplers
        # each seeing 1/N of the steps, scale local steps back up so the
        # schedule anneals at the configured global rate.
        samplers = max(1, self.config.get("num_rollout_workers", 0))
        return self._epsilon_at(self._steps_seen * samplers)

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        tobs = self._obs(obs)
        self._steps_seen += len(obs)
        if self._param_noise is not None:
            # parameter-space exploration: act greedily under the
            # PERTURBED network; re-perturb + adapt sigma periodically
            # (temporally consistent exploration, unlike per-step eps)
            self._since_perturb += len(obs)
            if self._since_perturb >= self.config.get(
                    "param_noise_interval", 64):
                clean = self._greedy(self.params, tobs)
                noisy = self._greedy(self._noisy_params, tobs)
                self._param_noise.adapt_sigma(clean, noisy)
                self._noisy_params = self._param_noise.perturb(
                    self.params)
                self._since_perturb = 0
            return {ACTIONS: self._greedy(self._noisy_params, tobs)}
        greedy = self._greedy(self.params, tobs)
        eps = self._epsilon()
        explore = self._rng.random(len(obs)) < eps
        random_a = self._rng.integers(0, self.num_actions, len(obs))
        return {ACTIONS: np.where(explore, random_a, greedy)}

    # -- learner side -----------------------------------------------------

    def _with_bonus(self, batch: SampleBatch) -> SampleBatch:
        if self._rnd is None:
            return batch
        # intrinsic novelty bonus on the NEXT state (the state the action
        # discovered); errors + predictor update in one pass
        nxt = np.asarray(batch[NEXT_OBS], np.float32)
        bonus = self._rnd.intrinsic_and_train(nxt)
        return SampleBatch({**batch, REWARDS: np.asarray(
            batch[REWARDS], np.float32)
            + self.config.get("rnd_coeff", 0.0) * bonus})

    def loss_and_grads(self, batch) -> tuple:
        """The loss and grads (numpy tree) of the update
        ``learn_on_batch(batch)`` would make, from the current params
        (without the RND bonus); changes nothing."""
        stats, grads = value_and_grad(
            lambda p: self._loss(p, dqn_device_batch(batch, self.device)),
            self.params)
        return float(stats["loss"]), tree_to_numpy(
            tree_unflatten(self.params, grads))

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        b = dqn_device_batch(self._with_bonus(batch), self.device)
        stats, grads = value_and_grad(lambda p: self._loss(p, b),
                                      self.params)
        self.params = tree_unflatten(self.params, self._opt.step(
            tree_leaves(self.params), grads))
        # One copy to the host: the loss, the mean |td| and the |td| rows
        # (the priorities are numpy).
        abs_td = stats["abs_td"]
        host = torch.cat([stats["loss"][None], torch.mean(abs_td)[None],
                          abs_td]).cpu().numpy()
        return {"loss": float(host[0]), "td_errors": host[2:],
                "mean_q_td": float(host[1])}

    def update_target(self):
        self.target_params = self.params

    def set_weights(self, weights):
        super().set_weights(weights)
        if self._param_noise is not None:
            # act under a perturbation of the FRESH weights immediately
            # (stale noisy params would ignore a weight sync for up to
            # param_noise_interval steps)
            self._noisy_params = self._param_noise.perturb(self.params)
            self._since_perturb = 0


class DQN(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "dqn")
        super().setup(config)
        if config.get("prioritized_replay", True):
            self.replay = PrioritizedReplayBuffer(
                config.get("buffer_size", 50_000),
                alpha=config.get("prioritized_replay_alpha", 0.6),
                seed=config.get("seed", 0))
        else:
            self.replay = ReplayBuffer(config.get("buffer_size", 50_000),
                                       seed=config.get("seed", 0))
        self._since_target_sync = 0

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batch = self.workers.synchronous_sample()
        self._timesteps_total += batch.count
        self._since_target_sync += batch.count
        self.replay.add(batch)

        stats: Dict[str, Any] = {}
        policy = self.workers.local_worker.policy
        if len(self.replay) >= c.get("learning_starts", 1000):
            for _ in range(c.get("num_train_iters", 8)):
                if isinstance(self.replay, PrioritizedReplayBuffer):
                    train = self.replay.sample(
                        c.get("train_batch_size", 64),
                        beta=c.get("prioritized_replay_beta", 0.4))
                else:
                    train = self.replay.sample(
                        c.get("train_batch_size", 64))
                stats = policy.learn_on_batch(train)
                if isinstance(self.replay, PrioritizedReplayBuffer):
                    self.replay.update_priorities(
                        train["batch_indexes"], stats.pop("td_errors"))
                else:
                    stats.pop("td_errors", None)
            if self._since_target_sync >= c.get(
                    "target_network_update_freq", 500):
                policy.update_target()
                self._since_target_sync = 0
            self.workers.sync_weights()
        return {"info": {"learner": {k: v for k, v in stats.items()
                                     if np.isscalar(v)}},
                "buffer_size": len(self.replay),
                # Report from GLOBAL timesteps: the local policy never
                # samples when remote workers exist, so its own counter
                # would misreport a frozen epsilon_initial.
                "epsilon": policy._epsilon_at(self._timesteps_total)}
