"""ray_tpu_torch.rllib: RL training library (reference analog: rllib/).

Port of ``ray_tpu/rllib/``, part 1: the envs, sample batches, the PPO
family and its dp learner, rollout workers, algorithms, offline RL, the
policy server, A2C, IMPALA, APPO and ES.  Env rollouts run on card-less
host-CPU actors, the learner on the card (``resources(device=...)``
chooses).  Part 2 (DQN, SAC, TD3, DDPG, multi-agent, QMIX, Ape-X) is not
ported yet: its policy names raise an ImportError that says so.
"""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig, A2CPolicy
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOPolicy
from ray_tpu_torch.rllib.es import ES, ESConfig
from ray_tpu_torch.rllib.env import (CartPoleVectorEnv, Env,
                                     PendulumVectorEnv, Space, VectorEnv,
                                     make_vector_env, register_env)
from ray_tpu_torch.rllib.catalog import AttentionPPOPolicy, ModelCatalog
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, ImpalaPolicy
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
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet

__all__ = [
    "A2C", "A2CConfig", "A2CPolicy", "APPO", "APPOConfig", "APPOPolicy",
    "Algorithm", "AlgorithmConfig", "AttentionPPOPolicy", "BC", "BCConfig",
    "BCPolicy", "ModelCatalog",
    "CartPoleVectorEnv", "CQL", "CQLConfig", "DatasetReader",
    "DatasetWriter", "ES", "ESConfig",
    "Env", "Impala",
    "ImpalaConfig", "ImpalaPolicy", "ImportanceSamplingEstimator",
    "MARWIL", "MARWILConfig", "MARWILPolicy",
    "PendulumVectorEnv", "Policy", "PolicyClient", "PolicyServerInput",
    "PPO", "PPOConfig", "PPOPolicy",
    "RecurrentPPO", "RecurrentPPOConfig",
    "RecurrentPPOPolicy", "RolloutWorker", "SampleBatch",
    "Space", "VectorEnv", "WorkerSet",
    "compute_gae", "make_vector_env", "register_env", "weights_from_jax",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu
