from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler, TrialScheduler)
from ray_tpu_torch.tune.schedulers.asha import ASHAScheduler
from ray_tpu_torch.tune.schedulers.hyperband import HyperBandScheduler
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining
from ray_tpu_torch.tune.schedulers.pb2 import PB2

__all__ = [
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "PB2",
]
