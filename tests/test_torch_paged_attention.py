"""The port's paged-attention ops against ray_tpu.ops.paged_attention.

Same numpy inputs through both; the port updates the pools in place and
the reference returns new ones, so the tests compare the pools after.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import append_kv, paged_attention, prefill_kv

# The module (ray_tpu.ops re-exports a function of the same name).
jpa = importlib.import_module("ray_tpu.ops.paged_attention")
NKV, P, PAGE, H = 2, 9, 4, 16


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((NKV, P, PAGE, H)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("N", [2, 4])          # MHA and GQA (rep 2)
def test_paged_attention_matches_jax(N):
    rng = np.random.default_rng(1)
    kp, vp = _pools()
    q = rng.standard_normal((3, N, H)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [8, 0, 0]], np.int64)
    lengths = np.array([12, 5, 1], np.int64)        # full, partial, one
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(lengths),
                               jnp.asarray(table))
    got = paged_attention(*(torch.from_numpy(x)
                            for x in (q, kp, vp, lengths, table)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_paged_attention_rejects_head_mismatch():
    kp, vp = (torch.from_numpy(x) for x in _pools())
    with pytest.raises(ValueError, match="multiple of KV heads"):
        paged_attention(torch.zeros(1, 3, H), kp, vp, torch.tensor([1]),
                        torch.tensor([[1]]))


def test_append_kv_matches_jax_in_place():
    rng = np.random.default_rng(2)
    kp, vp = _pools()
    k_new, v_new = (rng.standard_normal((3, NKV, H)).astype(np.float32)
                    for _ in range(2))
    table = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int64)
    pos = np.array([11, 6, 0], np.int64)    # last slot of the last page
    jk, jv = jpa.append_kv(*(jnp.asarray(x) for x in
                             (kp, vp, k_new, v_new, pos, table)))
    tk, tv = (torch.from_numpy(x.copy()) for x in (kp, vp))
    rk, rv = append_kv(tk, tv, *(torch.from_numpy(x) for x in
                                 (k_new, v_new, pos, table)))
    assert rk is tk and rv is tv                    # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("length", [1, 7, 12])
def test_prefill_kv_matches_jax(length):
    """Padding goes to scratch page 0; with length 12 the prompt fills its
    three pages exactly.  Page 0's contents are order-undefined."""
    rng = np.random.default_rng(3)
    kp, vp = _pools()
    S = 12
    k_seq, v_seq = (rng.standard_normal((NKV, S, H)).astype(np.float32)
                    for _ in range(2))
    row = np.array([6, 2, 7], np.int64)
    jk, jv = jpa.prefill_kv(jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(k_seq), jnp.asarray(v_seq),
                            jnp.int32(length), jnp.asarray(row))
    tk, tv = (torch.from_numpy(x.copy()) for x in (kp, vp))
    prefill_kv(tk, tv, torch.from_numpy(k_seq), torch.from_numpy(v_seq),
               length, torch.from_numpy(row))
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
