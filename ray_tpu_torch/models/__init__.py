"""ray_tpu_torch.models: model definitions as plain functions on tensors.

GPT only for now (training: loss, remat and the AdamW step; inference: the
full forward and the paged entry points the serving engine drives); LLaMA
comes in a later slice.
"""

from ray_tpu_torch.models.convert import (  # noqa: F401
    params_from_jax,
    params_to_numpy,
)
from ray_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    blocked_ce_loglike_sum,
    gpt_decode_step,
    gpt_forward,
    gpt_forward_with_aux,
    gpt_hidden,
    gpt_init,
    gpt_loss,
    gpt_prefill,
    init_paged_cache,
    make_train_state,
    make_train_step,
    token_loglikes,
)
