"""ray_tpu_torch.ops: the port's kernels and attention primitives.

``flash_attention`` (differentiable) launches the hand-written Hopper
kernels on CUDA tensors and their plain PyTorch versions on CPU tensors,
as does ``ops.splash_attention.splash_attention`` (block-sparse attention
over a mask's block map; import it from its module); the paged-attention
ops are plain PyTorch gathers and scatters, as the reference's are plain
jnp.
"""

from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_dkv_reference,
    flash_attention_dq_reference,
    flash_attention_fwd,
    flash_attention_reference,
)
from ray_tpu_torch.ops.paged_attention import (  # noqa: F401
    append_kv,
    paged_attention,
    prefill_kv,
)
