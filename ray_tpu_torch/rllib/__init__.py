"""ray_tpu_torch.rllib: RL training library (reference analog: rllib/).

Port of ``ray_tpu/rllib/``: the envs, sample batches, the PPO family and
its dp learner, rollout workers, algorithms, offline RL, the policy
server, A2C, IMPALA, APPO and ES (part 1), and the replay buffers,
exploration modules, DQN, Ape-X DQN, SAC, TD3, DDPG, multi-agent PPO and
QMIX (part 2).  Env rollouts and Ape-X's replay shards run on card-less
host-CPU actors, the learner on the card (``resources(device=...)``
chooses).
"""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig, A2CPolicy
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOPolicy
from ray_tpu_torch.rllib.ddpg import DDPG, DDPGConfig, DDPGPolicy
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNPolicy
from ray_tpu_torch.rllib.es import ES, ESConfig
from ray_tpu_torch.rllib.td3 import TD3, TD3Config, TD3Policy
from ray_tpu_torch.rllib.env import (CartPoleVectorEnv, Env,
                                     PendulumVectorEnv, Space, VectorEnv,
                                     make_vector_env, register_env)
from ray_tpu_torch.rllib.catalog import AttentionPPOPolicy, ModelCatalog
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, ImpalaPolicy
from ray_tpu_torch.rllib.apex_dqn import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.qmix import QMIX, QMIXConfig
from ray_tpu_torch.rllib.policy_server import (PolicyClient,
                                               PolicyServerInput)
from ray_tpu_torch.rllib.offline import (BC, BCConfig, BCPolicy, CQL,
                                         CQLConfig, DatasetReader,
                                         DatasetWriter,
                                         ImportanceSamplingEstimator,
                                         MARWIL, MARWILConfig,
                                         MARWILPolicy)
from ray_tpu_torch.rllib.policy import (Policy, PPOPolicy, compute_gae,
                                        weights_from_jax)
from ray_tpu_torch.rllib.ppo import (PPO, PPOConfig, RecurrentPPO,
                                     RecurrentPPOConfig)
from ray_tpu_torch.rllib.recurrent import RecurrentPPOPolicy
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.multi_agent import (CoordinationGameEnv,
                                             MultiAgentBatch, MultiAgentEnv,
                                             MultiAgentPPO,
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet

__all__ = [
    "A2C", "A2CConfig", "A2CPolicy", "APPO", "APPOConfig", "APPOPolicy",
    "Algorithm", "AlgorithmConfig", "AttentionPPOPolicy", "BC", "BCConfig",
    "BCPolicy", "ModelCatalog",
    "CartPoleVectorEnv", "CoordinationGameEnv", "CQL", "CQLConfig",
    "DatasetReader",
    "DatasetWriter", "DDPG", "DDPGConfig", "DDPGPolicy",
    "DQN", "DQNConfig", "DQNPolicy", "ES", "ESConfig",
    "Env", "Impala",
    "ImpalaConfig", "ImpalaPolicy", "ImportanceSamplingEstimator",
    "ApexDQN", "ApexDQNConfig",
    "MARWIL", "MARWILConfig", "MARWILPolicy",
    "MultiAgentBatch", "MultiAgentEnv", "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "PendulumVectorEnv", "Policy", "PolicyClient", "PolicyServerInput",
    "PPO", "PPOConfig", "PPOPolicy", "QMIX", "QMIXConfig",
    "PrioritizedReplayBuffer", "RecurrentPPO", "RecurrentPPOConfig",
    "RecurrentPPOPolicy", "ReplayBuffer", "RolloutWorker", "SAC",
    "SACConfig", "SACPolicy", "SampleBatch",
    "Space", "TD3", "TD3Config", "TD3Policy", "VectorEnv", "WorkerSet",
    "compute_gae", "make_vector_env", "register_env", "weights_from_jax",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu
