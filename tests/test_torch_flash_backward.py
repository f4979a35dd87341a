"""The port's flash-attention backward against the JAX package's.

The plain backward (what autograd runs on CPU tensors) is held to
``ray_tpu.ops.flash_attention._flash_bwd_impl`` in Pallas interpret mode on
the same ``(q, k, v, o, lse, g)``; autograd through the port's
``flash_attention`` is held to ``jax.grad`` of the JAX ``flash_attention``
(mirroring tests/test_ops.py's flash gradient tests); and no tensor with
two dims equal to S appears in the forward and backward (the twin of
``test_flash_bwd_memory_is_linear_in_seq``).  The Hopper kernels are held
to the plain backward on the card by test_torch_flash_bwd_kernel.py.

Tolerances: f32 2e-5 (sums in another order than XLA's, as in
tests/test_ops.py); bf16 2e-2 (dq, dk, dv rounded to bf16, a few ulps of
grads of magnitude up to ~5; the two agree exactly in practice, since both
round P and dS at the same places).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.ops.flash_attention import _dense_reference as jax_dense
from ray_tpu.ops.flash_attention import (_flash_bwd_impl, _flash_fwd_impl,
                                         flash_attention as jax_flash)

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))   # a writable copy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bsnh", "bnsh"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(16, 32), (32, 16), (64, 64)])
def test_plain_backward_matches_jax_kernels(dtype, layout, causal, blocks):
    B, S, N, H = 2, 64, 2, 16
    shape = (B, S, N, H) if layout == "bsnh" else (B, N, S, H)
    bq, bk = blocks
    q, k, v, g = (jnp.asarray(x, JNP[dtype]) for x in _inputs(shape, 4))
    o, lse = _flash_fwd_impl(q, k, v, causal=causal, block_q=bq, block_k=bk,
                             sm_scale=None, interpret=True, layout=layout)
    want = _flash_bwd_impl(q, k, v, o, lse, g, causal=causal, block_q=bq,
                           block_k=bk, sm_scale=None, interpret=True,
                           layout=layout)
    t = [torch.from_numpy(_np(x)).to(TORCH[dtype]) for x in (q, k, v, o, g)]
    got = fa.flash_attention_bwd_reference(
        t[0], t[1], t[2], t[3], torch.from_numpy(_np(lse)), t[4],
        causal, bq, bk, None, layout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TORCH[dtype] and a.shape == shape, name
        np.testing.assert_allclose(a.float().numpy(), _np(b),
                                   atol=TOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sm_scale", [0.0, -0.125, 0.3])
def test_plain_forward_and_backward_take_any_scale(dtype, causal, sm_scale):
    """A scale at or below zero (every score equal, or the order of the
    scores reversed) and a non-default positive one: the plain forward and
    backward against ``_flash_fwd_impl``/``_flash_bwd_impl`` in interpret
    mode, which scale by any ``sm_scale``."""
    shape, bq, bk = (2, 64, 2, 16), 32, 16
    q, k, v, g = (jnp.asarray(x, JNP[dtype]) for x in _inputs(shape, 4, 11))
    o, lse = _flash_fwd_impl(q, k, v, causal=causal, block_q=bq, block_k=bk,
                             sm_scale=sm_scale, interpret=True, layout="bsnh")
    want = _flash_bwd_impl(q, k, v, o, lse, g, causal=causal, block_q=bq,
                           block_k=bk, sm_scale=sm_scale, interpret=True,
                           layout="bsnh")
    t = [torch.from_numpy(_np(x)).to(TORCH[dtype]) for x in (q, k, v, o, g)]
    got_o, got_lse = fa.flash_attention_reference(t[0], t[1], t[2], causal,
                                                  bq, bk, sm_scale, "bsnh")
    np.testing.assert_allclose(got_o.float().numpy(), _np(o),
                               atol=TOL[dtype], rtol=0, err_msg="o")
    np.testing.assert_allclose(got_lse.numpy(), _np(lse), atol=TOL[dtype],
                               rtol=0, err_msg="lse")
    got = fa.flash_attention_bwd_reference(
        t[0], t[1], t[2], t[3], torch.from_numpy(_np(lse)), t[4], causal, bq,
        bk, sm_scale, "bsnh")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), _np(b),
                                   atol=TOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("S", [64, 200, 1024])
def test_stats_rows_as_the_kernels_read_them(S):
    """lse and D reach the backward kernels in rows of S rounded up to 64,
    zero past S (the dk/dv kernel copies 64 entries at a time and masks
    the padding); a tensor already so is passed on without a copy."""
    x = torch.randn(6, S)
    rows = fa._stats_rows(x)
    width = -(-S // 64) * 64
    assert rows.shape == (6, width) and rows.dtype == torch.float32
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
    torch.testing.assert_close(rows[:, :S], x, rtol=0, atol=0)
    assert not rows[:, S:].any()
    assert (rows.data_ptr() == x.data_ptr()) == (width == S)
    assert fa._stats_rows(rows).data_ptr() == rows.data_ptr()
    view = torch.randn(6, 2 * width)[:, ::2]       # strided: copied
    assert fa._stats_rows(view).is_contiguous()


def _port_grads(q, k, v, causal, bq, bk, layout="bsnh"):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*ts, causal, bq, bk, None, layout).sum().backward()
    return [x.grad.numpy() for x in ts]


@pytest.mark.parametrize("seed, S, blocks, causal", [
    (2, 32, (16, 16), True),     # test_flash_gradients
    (7, 64, (32, 16), True),     # test_flash_gradients_mixed_blocks
    (8, 32, (16, 16), False),    # test_flash_gradients_noncausal
])
def test_grads_match_jax(seed, S, blocks, causal):
    q, k, v = _inputs((1, S, 2, 8), seed=seed)
    bq, bk = blocks
    want = jax.grad(lambda q, k, v: jax_flash(q, k, v, causal, bq, bk).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    dense = jax.grad(lambda q, k, v: jax_dense(q, k, v, causal, None).sum(),
                     argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for got, a, b in zip(_port_grads(q, k, v, causal, bq, bk), want, dense):
        np.testing.assert_allclose(got, np.asarray(a), atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(b), atol=2e-5)


def test_bnsh_layout_forward_and_grads_match_jax():
    """Head-major layout (the GPT block's): forward and grads equal the
    JAX bnsh path and the bsnh dense reference."""
    q, k, v = _inputs((2, 32, 4, 8), seed=10)
    qb, kb, vb = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (qb, kb, vb)]
    out = fa.flash_attention(*ts, True, 16, 16, None, "bnsh")
    ref = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), True, None)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 1, 3),
                               np.asarray(ref), atol=2e-5)
    out.sum().backward()
    want = jax.grad(
        lambda q, k, v: jax_flash(q, k, v, True, 16, 16, None, None,
                                  "bnsh").sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (qb, kb, vb)))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor):
                self.shapes.append((str(func), tuple(x.shape)))
        return out


def test_bwd_memory_is_linear_in_seq():
    """No [S, S] tensor in the forward and backward: neither through
    autograd (the custom ops' own outputs) nor inside the plain versions
    they run on the CPU."""
    S = 256
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, S, 2, 8), 4, 9))
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with _Shapes() as rec:
        fa.flash_attention(*ts, True, 64, 64).sum().backward()
        o, lse = fa.flash_attention_reference(q, k, v, True, 64, 64)
        fa.flash_attention_bwd_reference(q, k, v, o, lse, g, True, 64, 64)
    assert any("flash_fwd" in f for f, _ in rec.shapes)
    assert any("flash_bwd" in f for f, _ in rec.shapes)
    quadratic = [(f, s) for f, s in rec.shapes if s.count(S) >= 2]
    assert not quadratic, quadratic[:5]
