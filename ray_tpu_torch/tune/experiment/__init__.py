from ray_tpu_torch.tune.experiment.trial import Trial

__all__ = ["Trial"]
