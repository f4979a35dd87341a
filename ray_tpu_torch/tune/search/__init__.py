from ray_tpu_torch.tune.search.searcher import ConcurrencyLimiter, Searcher
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.bayesopt import BayesOptSearcher
from ray_tpu_torch.tune.search.tpe import TPESearcher

__all__ = ["Searcher", "ConcurrencyLimiter", "BasicVariantGenerator",
           "BayesOptSearcher", "TPESearcher"]
