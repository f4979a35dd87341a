from ray_tpu_torch.runtime_env.runtime_env import (RuntimeEnv, env_hash,
                                             normalize_runtime_env)

__all__ = ["RuntimeEnv", "normalize_runtime_env", "env_hash"]
