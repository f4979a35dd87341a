"""Multi-agent RL: env contract, per-policy batches, mapped PPO training.

Port of ``ray_tpu/rllib/multi_agent.py``: the env contract, the batch and
the two games are copied (numpy), the sampler and ``MultiAgentPPO`` run
part 1's ``PPOPolicy``.  Design analog: reference
``rllib/env/multi_agent_env.py`` (dict-keyed obs/action/reward/done
protocol), ``rllib/policy/sample_batch.py:1218``
(MultiAgentBatch), and the ``multiagent`` config block
(policies + policy_mapping_fn).  Agents map to policies through a user
function; mapping every agent to one policy id gives shared-parameter
self-play, mapping them to distinct ids trains independent policies.

Per step, each policy runs ONE batched compute_actions over every (env,
agent) pair mapped to it — the host drives k env copies in numpy and the
device sees policy-wide batches, never per-agent calls.  The sampler
stays in the trainer's process, so its policies act and learn on the
trainer's device (``config["device"]``: None is the first card, raising
without one); the learner side reuses the PPO update per policy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, learner_cards
from ray_tpu_torch.rllib.policy import PPOPolicy, compute_gae
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP,
                                              ADVANTAGES, DONES, OBS,
                                              REWARDS, SampleBatch,
                                              VALUE_TARGETS, VF_PREDS)
from ray_tpu_torch.tune.trainable import Trainable


class MultiAgentEnv:
    """Simultaneous-move multi-agent env.

    reset() -> {agent_id: obs}; step({agent_id: action}) ->
    (obs_dict, reward_dict, done_dict, info_dict) where done_dict carries
    the special "__all__" key (reference multi_agent_env.py contract).
    """

    agents: List[str]
    observation_space = None     # Space shared by all agents
    action_space = None

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentBatch:
    """Per-policy SampleBatches + the env-step count they came from
    (reference sample_batch.py:1218)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = policy_batches
        self.count = env_steps

    def __getitem__(self, policy_id: str) -> SampleBatch:
        return self.policy_batches[policy_id]


class CoordinationGameEnv(MultiAgentEnv):
    """Two agents see a one-hot target and must BOTH pick it to score.

    Cooperative matrix game with a shared reward: +1 per step when both
    actions equal the target, else 0.  Random play scores ~T/16; the
    learned optimum is T.  Exists so multi-agent learning tests have a
    fast, deterministic threshold (the reference uses rock-paper-scissors
    and two-step-game examples the same way).
    """

    N_TARGETS = 4

    def __init__(self, episode_len: int = 16, seed: int = 0):
        from ray_tpu_torch.rllib.env import Space
        self.agents = ["agent_0", "agent_1"]
        self.observation_space = Space("box",
                                       shape=(self.N_TARGETS + 2,))
        self.action_space = Space("discrete", n=self.N_TARGETS)
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = 0

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, a in enumerate(self.agents):
            v = np.zeros(self.N_TARGETS + 2, np.float32)
            v[self._target] = 1.0
            v[self.N_TARGETS + i] = 1.0        # agent identity feature
            out[a] = v
        return out

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = int(self._rng.integers(self.N_TARGETS))
        return self._obs()

    def step(self, actions: Dict[str, Any]):
        hit = all(int(actions[a]) == self._target for a in self.agents)
        r = 1.0 if hit else 0.0
        self._t += 1
        done = self._t >= self.episode_len
        self._target = int(self._rng.integers(self.N_TARGETS))
        obs = self._obs()
        rewards = {a: r for a in self.agents}
        dones = {a: done for a in self.agents}
        dones["__all__"] = done
        return obs, rewards, dones, {}


class TwoStepGameEnv(MultiAgentEnv):
    """The QMIX paper's two-step cooperative game (Rashid et al. 2018).

    Step 1: agent_0's action picks the second-stage game (agent_1's
    first action is ignored).  Step 2A pays 7 regardless; step 2B pays
    [[0, 1], [1, 8]].  The optimum (8) requires agent_0 to choose the
    risky branch AND both agents to coordinate on action 1 there —
    independent learners settle on the safe 7, which is exactly the
    credit-assignment gap value factorization exists to close.
    Reference analog: ``rllib/examples/env/two_step_game.py`` (the env
    the reference's QMIX tests learn on).
    """

    PAYOFF_2B = ((0.0, 1.0), (1.0, 8.0))

    def __init__(self, seed: int = 0):
        from ray_tpu_torch.rllib.env import Space
        self.agents = ["agent_0", "agent_1"]
        self.observation_space = Space("box", shape=(5,))
        self.action_space = Space("discrete", n=2)
        self._state = 0     # 0 = first step, 1 = 2A, 2 = 2B

    def state(self) -> np.ndarray:
        v = np.zeros(3, np.float32)
        v[self._state] = 1.0
        return v

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for i, a in enumerate(self.agents):
            v = np.zeros(5, np.float32)
            v[self._state] = 1.0
            v[3 + i] = 1.0
            out[a] = v
        return out

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self._state = 0
        return self._obs()

    def step(self, actions: Dict[str, Any]):
        if self._state == 0:
            self._state = 1 if int(actions["agent_0"]) == 0 else 2
            r, done = 0.0, False
        elif self._state == 1:
            r, done = 7.0, True
        else:
            r = self.PAYOFF_2B[int(actions["agent_0"])][
                int(actions["agent_1"])]
            done = True
        obs = self._obs()
        rewards = {a: r for a in self.agents}
        dones = {a: done for a in self.agents}
        dones["__all__"] = done
        return obs, rewards, dones, {}


MA_ENV_REGISTRY: Dict[str, Callable[..., MultiAgentEnv]] = {
    "CoordinationGame-v0": CoordinationGameEnv,
    "TwoStepGame-v0": TwoStepGameEnv,
}


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MultiAgentPPO)
        self._config.update({
            "lambda": 0.95,
            "clip_param": 0.2,
            "vf_clip_param": 10.0,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "num_sgd_iter": 4,
            "sgd_minibatch_size": 128,
            "grad_clip": 0.5,
            "lr": 3e-4,
            "hiddens": (64, 64),
            "num_envs_per_worker": 8,
            "rollout_fragment_length": 64,
            "gamma": 0.99,
        })

    def multi_agent(self, *, policies: Dict[str, dict],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self._config["multiagent"] = {
            "policies": policies,
            "policy_mapping_fn": policy_mapping_fn,
        }
        return self


class MultiAgentRolloutSampler:
    """Drives k env copies; batches per-policy action computation."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        env_spec = config["env"]
        maker = MA_ENV_REGISTRY.get(env_spec, env_spec)
        if not callable(maker):
            raise ValueError(f"unknown multi-agent env {env_spec!r}")
        k = config.get("num_envs_per_worker", 8)
        seed = config.get("seed", 0)
        self.envs = [maker(**config.get("env_config", {}))
                     for _ in range(k)]
        self.obs = [e.reset(seed=seed * 1000 + i)
                    for i, e in enumerate(self.envs)]
        self.agents = list(self.envs[0].agents)
        ma = config.get("multiagent") or {
            "policies": {"default": {}},
            "policy_mapping_fn": lambda aid: "default",
        }
        self.mapping = ma["policy_mapping_fn"]
        obs_dim = int(np.prod(self.envs[0].observation_space.shape))
        self.policies: Dict[str, PPOPolicy] = {}
        for pid, overrides in ma["policies"].items():
            pconf = {**config, **(overrides or {})}
            self.policies[pid] = PPOPolicy(
                obs_dim, self.envs[0].action_space, pconf, seed=seed)
        # (env_idx, agent_id) pairs per policy — fixed agent sets.
        self.pairs: Dict[str, List[Tuple[int, str]]] = {}
        for i in range(len(self.envs)):
            for a in self.agents:
                pid = self.mapping(a)
                if pid not in self.policies:
                    raise ValueError(
                        f"policy_mapping_fn({a!r}) -> {pid!r}, which is not "
                        f"in policies {sorted(self.policies)}")
                self.pairs.setdefault(pid, []).append((i, a))
        unmapped = set(self.policies) - set(self.pairs)
        if unmapped:
            raise ValueError(
                f"policies {sorted(unmapped)} are configured but "
                f"policy_mapping_fn maps no agent to them")
        self._episode_reward = np.zeros(len(self.envs))
        self.completed_rewards: List[float] = []

    def sample(self) -> MultiAgentBatch:
        T = self.config.get("rollout_fragment_length", 64)
        gamma = self.config.get("gamma", 0.99)
        lam = self.config.get("lambda", 0.95)
        k = len(self.envs)
        buf = {pid: {key: [] for key in
                     (OBS, ACTIONS, ACTION_LOGP, REWARDS, DONES, VF_PREDS)}
               for pid in self.policies}
        for _ in range(T):
            # one batched forward per policy across its (env, agent) pairs
            acts: Dict[Tuple[int, str], Any] = {}
            for pid, pairs in self.pairs.items():
                obs_mat = np.stack([self.obs[i][a] for i, a in pairs])
                out = self.policies[pid].compute_actions(obs_mat)
                for j, (i, a) in enumerate(pairs):
                    acts[(i, a)] = (out[ACTIONS][j], out[ACTION_LOGP][j],
                                    out[VF_PREDS][j])
                buf[pid][OBS].append(obs_mat)
                buf[pid][ACTIONS].append(out[ACTIONS])
                buf[pid][ACTION_LOGP].append(out[ACTION_LOGP])
                buf[pid][VF_PREDS].append(out[VF_PREDS])
            rew_step = {pid: np.zeros(len(pairs))
                        for pid, pairs in self.pairs.items()}
            done_step = {pid: np.zeros(len(pairs), bool)
                         for pid, pairs in self.pairs.items()}
            for i, env in enumerate(self.envs):
                actions = {a: acts[(i, a)][0] for a in self.agents}
                obs, rewards, dones, _ = env.step(actions)
                self.obs[i] = obs
                self._episode_reward[i] += sum(rewards.values())
                if dones.get("__all__"):
                    self.completed_rewards.append(
                        float(self._episode_reward[i]))
                    self._episode_reward[i] = 0.0
                    self.obs[i] = env.reset()
                for pid, pairs in self.pairs.items():
                    for j, (ei, a) in enumerate(pairs):
                        if ei == i:
                            rew_step[pid][j] = rewards[a]
                            done_step[pid][j] = dones.get(
                                a, dones.get("__all__", False))
            for pid in self.policies:
                buf[pid][REWARDS].append(rew_step[pid])
                buf[pid][DONES].append(done_step[pid])

        batches = {}
        for pid, policy in self.policies.items():
            pairs = self.pairs[pid]
            last_obs = np.stack([self.obs[i][a] for i, a in pairs])
            last_v = policy.compute_values(last_obs)
            arr = {key: np.stack(v) for key, v in buf[pid].items()}  # [T,K]
            adv, vt = compute_gae(arr[REWARDS].astype(np.float32),
                                  arr[VF_PREDS].astype(np.float32),
                                  arr[DONES], last_v, gamma, lam)

            def flat(a):
                return np.concatenate([a[:, j] for j in range(len(pairs))])

            batches[pid] = SampleBatch({
                OBS: flat(arr[OBS]), ACTIONS: flat(arr[ACTIONS]),
                ACTION_LOGP: flat(arr[ACTION_LOGP]),
                VF_PREDS: flat(arr[VF_PREDS]),
                ADVANTAGES: flat(adv), VALUE_TARGETS: flat(vt),
            })
        return MultiAgentBatch(batches, T * k)


class MultiAgentPPO(Trainable):
    """Synchronous multi-agent PPO over mapped policies.

    Single-process sampler (the multi-agent worker fan-out composes the
    same way the single-agent WorkerSet does; kept local until a workload
    needs it — reference rllib trains multi-agent through the same
    training_step with MultiAgentBatch).
    """

    def setup(self, config: Dict[str, Any]) -> None:
        self.sampler = MultiAgentRolloutSampler(config)
        self._timesteps_total = 0
        import collections
        self._episode_rewards = collections.deque(maxlen=100)

    def step(self) -> Dict[str, Any]:
        batch = self.sampler.sample()
        self._timesteps_total += batch.count
        stats = {}
        for pid, policy in self.sampler.policies.items():
            stats[pid] = policy.learn_on_batch(batch[pid])
        self._episode_rewards.extend(self.sampler.completed_rewards)
        self.sampler.completed_rewards.clear()
        result = {"info": {"learner": stats},
                  "num_env_steps_sampled": self._timesteps_total}
        if self._episode_rewards:
            result["episode_reward_mean"] = float(
                np.mean(self._episode_rewards))
        return result

    def save_checkpoint(self) -> Dict[str, Any]:
        return {pid: p.get_weights()
                for pid, p in self.sampler.policies.items()}

    def load_checkpoint(self, checkpoint) -> None:
        if not checkpoint:
            return
        for pid, w in checkpoint.items():
            self.sampler.policies[pid].set_weights(w)

    def cleanup(self) -> None:
        pass

    @classmethod
    def default_resource_request(cls, config: Dict[str, Any]
                                 ) -> Dict[str, float]:
        """One CPU, and the card the policies run on unless the config
        puts them on the CPU."""
        return {"CPU": 1.0, **learner_cards(config)}
