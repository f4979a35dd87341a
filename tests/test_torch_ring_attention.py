"""The port's ring and Ulysses attention against the JAX package's.

Mirrors tests/test_ops.py:113-148: ring attention at sp=8; at dp=2 x sp=4
with the batch sharded; the gradient with respect to q at sp=4; Ulysses
at sp=4 under shard_map.  Each is held to ``ring_attention`` /
``ulysses_attention`` run under JAX on the same seeded numpy inputs (and
to the dense causal reference), at the reference tests' atol 2e-5 in f32.
Adds sp=1 (one causal block) and ``make_ring_attention_fn`` refusing a
mesh whose sp is 1.

The torch side runs in two gloo gangs (8 and 4 ranks, 120 s deadline
each); their rank functions are in ``_torch_gang.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import _torch_gang as gang
from ray_tpu.ops.flash_attention import _dense_reference
from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh

ATOL = 2e-5
DEADLINE_S = 120


def _qkv(seed, B=2, S=64, N=4, H=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, N, H)).astype(np.float32)
                 for _ in range(3))


def _dense(q, k, v):
    return np.asarray(_dense_reference(*map(jnp.asarray, (q, k, v)), True,
                                       None))


SP8, DP2_SP4 = _qkv(3), _qkv(4, B=4, S=32)
GRADS, ULYSSES = _qkv(5, B=1, S=32, N=2, H=8), _qkv(6, B=2, S=64, N=8, H=8)
SP1 = _qkv(7, B=4, S=16, N=2, H=8)


@pytest.fixture(scope="module")
def world8():
    return gang.run(gang.ring_world8, 8, (SP8, DP2_SP4),
                    timeout_s=DEADLINE_S)[0]


@pytest.fixture(scope="module")
def world4():
    return gang.run(gang.ring_world4, 4, (GRADS, ULYSSES, SP1),
                    timeout_s=DEADLINE_S)[0]


def _jax_ring(qkv, spec):
    return np.asarray(ring_attention(*map(jnp.asarray, qkv), spec.build()))


def test_ring_attention_matches_dense(world8):
    want = _jax_ring(SP8, JMeshSpec(sp=8))
    np.testing.assert_allclose(world8["sp8"], want, atol=ATOL)
    np.testing.assert_allclose(world8["sp8"], _dense(*SP8), atol=ATOL)


def test_ring_attention_sp4_with_batch_sharding(world8):
    want = _jax_ring(DP2_SP4, JMeshSpec(dp=2, sp=4))
    np.testing.assert_allclose(world8["dp2_sp4"], want, atol=ATOL)
    np.testing.assert_allclose(world8["dp2_sp4"], _dense(*DP2_SP4),
                               atol=ATOL)


def test_ring_attention_grads_flow(world4):
    q, k, v = map(jnp.asarray, GRADS)
    mesh = JMeshSpec(sp=4).build()
    g = jax.grad(lambda q: ring_attention(q, k, v, mesh).sum())(q)
    gd = jax.grad(lambda q: _dense_reference(q, k, v, True, None).sum())(q)
    np.testing.assert_allclose(world4["grads_q"], np.asarray(g), atol=ATOL)
    np.testing.assert_allclose(world4["grads_q"], np.asarray(gd), atol=ATOL)
    np.testing.assert_allclose(world4["grads_out"], _dense(*GRADS),
                               atol=ATOL)


def test_ulysses_matches_dense(world4):
    mesh = jmake_mesh({"sp": 4})
    spec = JP(None, "sp", None, None)
    want = np.asarray(jax.shard_map(
        ulysses_attention, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=spec)(*map(jnp.asarray, ULYSSES)))
    np.testing.assert_allclose(world4["ulysses"], want, atol=ATOL)
    np.testing.assert_allclose(world4["ulysses"], _dense(*ULYSSES),
                               atol=ATOL)


def test_ring_at_sp1_is_one_causal_block(world4):
    np.testing.assert_allclose(world4["sp1"], _dense(*SP1), atol=ATOL)
    assert "size > 1" in world4["sp1_refused"]
