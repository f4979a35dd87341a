"""The port's MLP (ray_tpu_torch.models.mlp) against the JAX package's.

Mirrors ``test_mlp_trains`` of tests/test_models.py and holds the forward,
``mlp_loss`` and its grads to ``ray_tpu.models.mlp`` on weights converted
from the JAX init, in f32 (sums in another order: rtol 1e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu_torch.models import (mlp_forward, mlp_init, mlp_loss,
                                  params_from_jax, params_to_numpy)

CPU = "cpu"
SIZES = [4, 16, 3]


def _data(n=32, seed=1):
    x = np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)
    return x, (x.sum(axis=1) > 0).astype(np.int64)


def _params(sizes=SIZES):
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), sizes)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(tree, sizes, device=CPU)


def test_mlp_trains():
    params = mlp_init(0, SIZES, device=CPU)
    leaves = [t.requires_grad_(True) for layer in params.values()
              for t in layer.values()]
    x, y = _data()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    loss0 = float(mlp_loss(params, batch).detach())
    for _ in range(50):
        grads = torch.autograd.grad(mlp_loss(params, batch), leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= 0.1 * g
    assert float(mlp_loss(params, batch).detach()) < loss0


@pytest.mark.parametrize("sizes", [SIZES, [6, 32, 32, 5]])
def test_mlp_loss_and_grads_match_jax(sizes):
    jp, params = _params(sizes)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], 16)
    want_logits = jmlp.mlp_forward(jp, jnp.asarray(x))
    loss, grads = jax.value_and_grad(jmlp.mlp_loss)(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)})
    leaves = [params[k][n] for k in params for n in ("w", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got_logits = mlp_forward(params, torch.from_numpy(x))
    got = mlp_loss(params, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)})
    got_grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    want = [np.asarray(grads[k][n]) for k in params for n in ("w", "b")]
    for g, w in zip(got_grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_mlp_params_convert_both_ways():
    jp, params = _params()
    back = params_to_numpy(params)
    for k in jp:
        for n in ("w", "b"):
            np.testing.assert_array_equal(back[k][n], np.asarray(jp[k][n]))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(KeyError, match="layer2"):
        params_from_jax(tree, [4, 16, 3, 2], device=CPU)
    with pytest.raises(ValueError, match="layer0.w"):
        params_from_jax(tree, [5, 16, 3], device=CPU)
    with pytest.raises(TypeError, match="no params layout"):
        params_from_jax(tree, "mlp", device=CPU)
    init = mlp_init(3, SIZES, device=CPU)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in init.items()} == {
        "layer0": {"w": (4, 16), "b": (16,)},
        "layer1": {"w": (16, 3), "b": (3,)}}
    torch.testing.assert_close(mlp_init(3, SIZES, device=CPU)["layer0"]["w"],
                               init["layer0"]["w"], rtol=0, atol=0)
