from ray_tpu_torch.train.torch.config import (TorchConfig,
                                              prepare_data_loader,
                                              prepare_model)
from ray_tpu_torch.train.torch.dcp_checkpoint import (TorchCheckpoint,
                                                      restore_sharded,
                                                      save_sharded)
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer

__all__ = ["TorchCheckpoint", "TorchConfig", "TorchTrainer",
           "prepare_data_loader", "prepare_model", "restore_sharded",
           "save_sharded"]
