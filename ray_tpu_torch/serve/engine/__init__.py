"""ray_tpu_torch.serve.engine — streaming LLM inference engine.

Continuous batching over a paged KV cache (vLLM-style iteration-level
scheduling).  See engine.py for the loop and kv_cache.py for the page
accounting.
"""

from ray_tpu_torch.serve.engine.engine import (  # noqa: F401
    DeadlineExceeded,
    EngineConfig,
    InferenceEngine,
    LLMServer,
)
from ray_tpu_torch.serve.engine.kv_cache import (  # noqa: F401
    PageAllocator,
    table_row,
)
