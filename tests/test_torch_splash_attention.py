"""The port's splash attention (``ray_tpu_torch.ops.splash_attention``)
against JAX's splash kernels as the repo reaches them
(``ray_tpu.autotune.dispatch.make_splash_kernel``), run in interpret mode
on the CPU, on the same seeded numpy inputs.

Tolerances: o within 2e-5 and grads within 1e-4 (f32, absolute): the
same f32 recurrence, summed in another order; the block maps exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_mask as jmask)
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_mask_info as jmask_info)

from ray_tpu.autotune import dispatch as jdispatch
from ray_tpu.ops.flash_attention import _dense_reference as jdense
from ray_tpu_torch.autotune import dispatch
from ray_tpu_torch.autotune import cache as tcache
from ray_tpu_torch.ops import splash_attention as sp

B, N, S, H = 1, 2, 256, 128
O_TOL, GRAD_TOL = 2e-5, 1e-4


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_AUTOTUNE_CACHE", str(tmp_path / "at.jsonl"))
    tcache._CACHES.clear()
    dispatch.clear_memo()
    yield
    tcache._CACHES.clear()
    dispatch.clear_memo()


# --------------------------------------------------------------- block maps

@pytest.mark.parametrize("S_, block, offsets", [
    (256, (128, 128), (0, 0)),
    (512, (128, 256), (0, 0, 0)),
    (512, (256, 128), (0, 0)),
    (1024, (256, 512), (0,)),
    (512, (128, 128), (0, 128)),          # two maps: one per head
    (512, (256, 128), (128, 128, 384)),
])
def test_block_map_equals_jax(S_, block, offsets):
    jm = jmask.MultiHeadMask([jmask.CausalMask((S_, S_), offset=o)
                              for o in offsets])
    want, _ = jmask_info._process_mask(jm, block, False, shrink_grid=False)
    info = sp.process_mask(sp.causal_mha_mask(len(offsets), S_, offsets),
                           block)
    np.testing.assert_array_equal(info.block_mask,
                                  np.asarray(want.block_mask))
    # The non-empty lists follow from the map: ascending, flagged full.
    for table, kinds in ((info.rows, info.block_mask),
                         (info.cols, info.block_mask.transpose(0, 2, 1))):
        for h in range(kinds.shape[0]):
            for r in range(kinds.shape[1]):
                idx = np.nonzero(kinds[h, r])[0]
                n = table[h, r, 0]
                assert n == len(idx)
                np.testing.assert_array_equal(table[h, r, 1:1 + n] >> 1, idx)
                np.testing.assert_array_equal(table[h, r, 1:1 + n] & 1,
                                              kinds[h, r, idx] == 2)


def test_map_is_built_once_and_kept_per_device():
    mask = sp.causal_mha_mask(2, 256)
    info = sp.process_mask(mask, (128, 128))
    assert sp.process_mask(sp.causal_mha_mask(2, 256), (128, 128)) is info
    assert info.block_mask.shape == (1, 2, 2)      # broadcast over heads
    assert info.tensors("cpu")[1] is info.tensors("cpu")[1]


def test_mask_with_a_row_that_sees_no_key_raises():
    with pytest.raises(ValueError, match="no key"):
        sp.process_mask(sp.CausalMask((256, 256), offset=-1), (128, 128))
    with pytest.raises(ValueError, match="multiple of 128"):
        sp.process_mask(sp.causal_mha_mask(1, 256), (64, 128))


# ------------------------------------------------------- against JAX's kernels

@pytest.fixture(scope="module")
def jax_splash():
    """JAX's splash kernels at [1, 2, 256, 128] f32, 128-blocks (block map
    [[1, 0], [2, 1]]: partial, empty and full blocks): o and the grads of
    sum(o * g) through make_splash_kernel, and the logsumexp residual of
    the same kernel built with save_residuals."""
    from jax.experimental.pallas.ops.tpu import splash_attention as spl
    q, k, v, g = _inputs(0, (B, N, S, H))
    q = q * H ** -0.5                        # the caller pre-scales q
    kern = jdispatch.make_splash_kernel(N, S, None, True)

    def f(q, k, v):
        return jax.vmap(kern)(q, k, v)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g))
    sizes = spl.BlockSizes(block_q=128, block_kv=128, block_kv_compute=128,
                           block_q_dkv=128, block_kv_dkv=128,
                           block_kv_dkv_compute=128, block_q_dq=128,
                           block_kv_dq=128)
    res = spl.make_splash_mha(
        jmask.MultiHeadMask([jmask.CausalMask((S, S)) for _ in range(N)]),
        head_shards=1, q_seq_shards=1, block_sizes=sizes, interpret=True,
        save_residuals=True)
    lse = jax.vmap(lambda q, k, v: res(q, k, v)[1][0])(q, k, v)
    return {"inputs": (q, k, v, g), "o": np.asarray(o),
            "lse": np.asarray(lse),
            "grads": [np.asarray(x) for x in grads]}


def test_plain_forward_matches_jax_kernel(jax_splash):
    q, k, v, _ = jax_splash["inputs"]
    info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
    np.testing.assert_array_equal(info.block_mask, [[[1, 0], [2, 1]]])
    o, lse = sp.splash_attention_reference(_t(q), _t(k), _t(v), info)
    np.testing.assert_allclose(o.numpy(), jax_splash["o"], atol=O_TOL)
    np.testing.assert_allclose(lse.numpy(), jax_splash["lse"], atol=O_TOL)


def test_autograd_grads_match_jax_grad(jax_splash):
    q, k, v, g = jax_splash["inputs"]
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
    o = sp.splash_attention(qt, kt, vt, info)
    np.testing.assert_allclose(o.detach().numpy(), jax_splash["o"],
                               atol=O_TOL)
    (o * _t(g)).sum().backward()
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad),
                               jax_splash["grads"]):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_plain_backward_pieces_match_autograd(jax_splash):
    """splash_dq_reference and splash_dkv_reference are the op's backward."""
    q, k, v, g = jax_splash["inputs"]
    info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
    qt, kt, vt, gt = _t(q), _t(k), _t(v), _t(g)
    o, lse = sp.splash_attention_reference(qt, kt, vt, info)
    dq = sp.splash_dq_reference(qt, kt, vt, o, lse, gt, info)
    dk, dv = sp.splash_dkv_reference(qt, kt, vt, o, lse, gt, info)
    for got, want in zip((dq, dk, dv), jax_splash["grads"]):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL)
    np.testing.assert_array_equal(
        torch.stack(sp.splash_attention_bwd(qt, kt, vt, o, lse, gt, info)),
        torch.stack((dq, dk, dv)))


def test_dispatched_splash_matches_jax_dispatch(cache_file):
    q, k, v = _inputs(3, (1, S, 1, H), n=3)        # bsnh, one head
    want = jdispatch.attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=True, variant="splash", interpret=True)
    got = dispatch.attention(_t(q), _t(k), _t(v), causal=True,
                             variant="splash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=O_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdense(q, k, v, True, None)), atol=2e-4)


# ------------------------------------------------------ the port on its own

@pytest.mark.parametrize("fwd, bwd", [(128, 128), (128, 256), (256, 512),
                                      (512, 128)])
def test_every_block_shape_gives_the_same_attention(fwd, bwd):
    """The block knobs change the walk, not the function: fwd and grads at
    each (fwd, bwd) block pair equal dense causal attention (f32, 2e-5
    and 1e-4)."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5, (1, 2, 512, 128)))
    q = q * 128 ** -0.5
    kern = dispatch.make_splash_kernel(2, 512, {
        "block_q": fwd, "block_kv": fwd, "block_q_bwd": bwd,
        "block_kv_bwd": bwd}, "cpu")

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        (o * g).sum().backward()
        return o.detach(), [x.grad for x in leaves]

    def dense(q, k, v):
        s = torch.einsum("bnqh,bnkh->bnqk", q, k)
        s = torch.where(torch.ones(512, 512, dtype=torch.bool).tril(), s,
                        sp.MASK_VALUE)
        return torch.softmax(s, -1) @ v

    o, gs = grads(kern)
    ro, rgs = grads(dense)
    torch.testing.assert_close(o, ro, atol=O_TOL, rtol=0)
    for a, b in zip(gs, rgs):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=0)


def test_per_head_offsets_match_dense():
    """A map per head (offsets 0 and 128): partial blocks evaluate each
    head's own mask function."""
    offsets = (0, 128)
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, (2, 2, 256, 128), 3))
    info = sp.process_mask(sp.causal_mha_mask(2, 256, offsets), (128, 128))
    assert info.block_mask.shape[0] == 2
    o, lse = sp.splash_attention_reference(q, k, v, info)
    rows = torch.arange(256)[:, None]
    mask = torch.stack([rows + off >= torch.arange(256)[None]
                        for off in offsets])
    s = torch.where(mask, torch.einsum("bnqh,bnkh->bnqk", q, k),
                    sp.MASK_VALUE)
    torch.testing.assert_close(o, torch.softmax(s, -1) @ v, atol=O_TOL,
                               rtol=0)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=O_TOL,
                               rtol=0)


def test_kernel_path_rejects_what_it_cannot_take():
    """The wrapper's checks hold before any launch (meta tensors stand in
    for CUDA ones: the checks read shapes, dtypes and strides only)."""
    q = torch.empty((1, 2, 256, 96), device="meta")
    with pytest.raises(ValueError, match="head dims"):
        sp._check_kernel_inputs(q, k=q, v=q)
    q16 = torch.empty((1, 2, 256, 128), device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sp._check_kernel_inputs(q16, k=q16, v=q16)


def _bf16_view(kind):
    """A bf16 [1, 2, 256, H] CPU tensor that the kernels' TMA maps cannot
    take, or an fp16 one."""
    if kind == "misaligned strides":          # row stride 129 elements
        return torch.zeros(1, 2, 256, 129, dtype=torch.bfloat16)[..., :128]
    if kind == "misaligned base":             # 2 bytes past an aligned base
        flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.bfloat16)
        return flat[1:].view(1, 2, 256, 128)
    if kind == "head dim not contiguous":
        return torch.zeros(1, 2, 128, 256, dtype=torch.bfloat16).transpose(
            -1, -2)
    if kind == "odd head dim":
        return torch.zeros(1, 2, 256, 65, dtype=torch.bfloat16)
    return torch.zeros(1, 2, 256, 128, dtype=torch.float16)


@pytest.mark.parametrize("kind, match", [
    ("misaligned strides", "multiples of 16"),
    ("misaligned base", "multiples of 16"),
    ("head dim not contiguous", "contiguous"),
    ("odd head dim", "head dims"),
    ("fp16", "float32 or bfloat16"),
])
def test_kernel_inputs_guard_the_tma_maps(kind, match):
    """The checks before a launch that keep the TMA maps valid: base and
    byte strides multiples of 16, the head dim contiguous, a head dim and
    dtype the kernels were built for."""
    x = _bf16_view(kind)
    good = torch.zeros(x.shape, dtype=x.dtype)
    with pytest.raises(ValueError, match=match):
        sp._check_kernel_inputs(good, k=good, v=x)
    with pytest.raises(ValueError, match=match):
        sp._check_kernel_inputs(x, k=x, v=x)
