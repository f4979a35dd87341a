"""The port's flash-attention forward against the JAX package's.

The plain PyTorch version (what the wrapper runs on CPU tensors) is held to
``ray_tpu.ops.flash_attention._flash_fwd_impl`` in Pallas interpret mode on
the same numpy inputs, on ``o`` and on ``lse``.  The Hopper kernel itself
is held to the plain version on the card by test_torch_flash_kernel.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _dense_reference as jax_dense
from ray_tpu.ops.flash_attention import _flash_fwd_impl

# The module (ray_tpu_torch.ops re-exports a function of the same name).
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# f32: sums in another order than XLA's.  bf16: o is rounded to bf16 and p
# is rounded before P.V, each a few bf16 ulps near magnitude 1.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bsnh", "bnsh"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(16, 32), (32, 16), (64, 64)])
def test_plain_matches_jax_kernel(dtype, layout, causal, blocks):
    B, S, N, H = 2, 64, 2, 16
    shape = (B, S, N, H) if layout == "bsnh" else (B, N, S, H)
    q, k, v = _inputs(shape)
    bq, bk = blocks
    oj, lj = _flash_fwd_impl(*(jnp.asarray(x, JNP[dtype]) for x in (q, k, v)),
                             causal=causal, block_q=bq, block_k=bk,
                             sm_scale=None, interpret=True, layout=layout)
    ot, lt = fa.flash_attention_reference(
        *(torch.from_numpy(x).to(TORCH[dtype]) for x in (q, k, v)),
        causal, bq, bk, None, layout)
    assert ot.dtype == TORCH[dtype] and ot.shape == shape
    assert lt.dtype == torch.float32 and lt.shape == (B * N, S)
    np.testing.assert_allclose(ot.float().numpy(), _np(oj), atol=TOL[dtype],
                               rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_twin_matches_jax_dense(causal):
    q, k, v = _inputs((2, 48, 2, 16), seed=1)
    want = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), causal, None)
    got = fa._dense_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("S", [50, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_tail_matches_dense(S, causal):
    """S not a multiple of the blocks: the last block is partial."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, S, 2, 16), seed=2))
    o, lse = fa.flash_attention_reference(q, k, v, causal, 64, 32)
    np.testing.assert_allclose(
        o.numpy(), fa._dense_reference(q, k, v, causal, None).numpy(),
        atol=2e-5)
    s = torch.einsum("bqnh,bknh->bnqk", q, k) / 4.0
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1).reshape(2, S).numpy(),
                               atol=2e-5)


def test_cpu_tensors_run_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 32, 2, 16)))
    before = fa.flash_attention.launches
    o = fa.flash_attention(q, k, v, causal=True, layout="bsnh")
    assert fa.flash_attention.launches == before      # no kernel launched
    np.testing.assert_array_equal(
        o.numpy(), fa.flash_attention_reference(q, k, v, True)[0].numpy())


def test_inputs_that_require_grad_get_grads():
    """CPU tensors that require grad differentiate through the plain
    backward; no kernel is launched."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs((1, 16, 1, 16)))
    before = (fa.flash_attention.launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    fa.flash_attention(q, k, v).square().sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               and x.grad.abs().sum() > 0 for x in (q, k, v))
    assert (fa.flash_attention.launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == before


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 16, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("make, match", [
    (lambda: torch.zeros(1, 16, 2, 48), "head dims"),
    (lambda: torch.zeros(1, 16, 2, 16, dtype=torch.float16), "float32 or"),
    (lambda: torch.zeros(1, 16, 16, 2).transpose(2, 3), "contiguous"),
    (lambda: torch.zeros(1, 16, 2, 18)[..., :16], "aligned"),
])
def test_kernel_input_checks(make, match):
    x = make()
    with pytest.raises(ValueError, match=match):
        fa._check_kernel_inputs(x, x, x)


def test_shape_mismatch_raises():
    q, k, _ = (torch.from_numpy(x) for x in _inputs((1, 16, 1, 16)))
    with pytest.raises(ValueError, match="4-d shape"):
        fa.flash_attention(q, k, k[:, :8])
