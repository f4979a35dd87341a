"""Hyperparameter tuning (Ray Tune equivalent).

Port of ``ray_tpu/tune/__init__.py``. Design analog: reference
``python/ray/tune/`` -- Tuner.fit (tuner.py:249), TrialRunner event loop
(execution/trial_runner.py:969), Trainable contract
(trainable/trainable.py:66), search spaces (tune/search/), schedulers
(tune/schedulers/: ASHA async_hyperband.py, PBT pbt.py, median stopping).
Trials are actors gang-placed like any other workload; a trial whose
Trainable is a TorchTrainer runs a nested worker gang on its cards
(``ScalingConfig(use_gpu=True)``), and a ``"GPU"`` key in a trial's
resources leases it whole cards.  Importing the package imports no torch.
"""

from ray_tpu_torch.tune.search.sample import (
    choice, grid_search, lograndint, loguniform, qrandint, quniform,
    randint, randn, uniform, sample_from)
from ray_tpu_torch.tune.trainable import Trainable, with_parameters, with_resources
from ray_tpu_torch.tune.tune_config import TuneConfig
from ray_tpu_torch.tune.tuner import Tuner
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.air import session as _session

# Function-API report surface (reference: ray.tune.report / air session).
report = _session.report
get_checkpoint = _session.get_checkpoint

__all__ = [
    "Trainable", "TuneConfig", "Tuner", "ResultGrid",
    "choice", "grid_search", "lograndint", "loguniform", "qrandint",
    "quniform", "randint", "randn", "uniform", "sample_from",
    "with_parameters", "with_resources", "report", "get_checkpoint",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("tune")
del _rlu
