"""ray_tpu_torch.models: model definitions as plain functions on tensors.

GPT only for now (inference: the full forward and the paged entry points
the serving engine drives); LLaMA comes in a later slice.
"""

from ray_tpu_torch.models.convert import params_from_jax  # noqa: F401
from ray_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    gpt_decode_step,
    gpt_forward,
    gpt_forward_with_aux,
    gpt_hidden,
    gpt_init,
    gpt_prefill,
    init_paged_cache,
    token_loglikes,
)
