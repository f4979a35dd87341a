"""ray_tpu_torch.models: model definitions as plain functions on tensors.

GPT and LLaMA (training: loss, remat and the AdamW step; inference: the
full forward and the paged entry points the serving engine drives), and
the small ReLU MLP of the train and tune tests.  The LLaMA train-state
and train-step functions are exported with a ``llama_`` prefix beside
GPT's.
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
from ray_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    apply_rope,
    llama_decode_step,
    llama_forward,
    llama_hidden,
    llama_init,
    llama_init_paged_cache,
    llama_loss,
    llama_prefill,
    rope_tables,
)
from ray_tpu_torch.models.llama import (  # noqa: F401
    make_train_state as llama_make_train_state,
    make_train_step as llama_make_train_step,
)
from ray_tpu_torch.models.mlp import (  # noqa: F401
    mlp_forward,
    mlp_init,
    mlp_loss,
)
