"""Kernel autotune subsystem: block-config search, persistent cache, and
measured kernel-variant dispatch (port of ``ray_tpu/autotune/``).

* ``cache``    JSON-lines persistent cache, keyed by (op, backend
  fingerprint, canonical shape key); survives restarts, shared across
  processes.
* ``search``   timing harness and block sweeps per registered op (splash
  fwd/bwd blocks; flash's blocks on the CPU only), device-aware: the plain
  versions on the CPU, the Hopper kernels on the card.
* ``dispatch`` ``attention(q, k, v, ...)`` picks splash / flash / dense
  per shape from measured crossover records.
* ``sweep``    ``python -m ray_tpu_torch.autotune.sweep``: the offline
  sweep that fills the cache for a fleet's shapes.

Importing this package stays cheap: it imports ``metrics`` and ``cache``
only; import ``search`` and ``dispatch`` explicitly.
"""

from ray_tpu_torch.autotune import metrics  # noqa: F401
from ray_tpu_torch.autotune.cache import (AutotuneCache, attention_key,  # noqa
                                          backend_fingerprint, cache_path,
                                          canon_dtype, get_cache, norm_batch)

__all__ = ["AutotuneCache", "attention_key", "backend_fingerprint",
           "cache_path", "canon_dtype", "get_cache", "norm_batch",
           "metrics"]
