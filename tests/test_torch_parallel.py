"""The port's parallel layer (ray_tpu_torch.parallel) against the JAX one.

Mirrors tests/test_parallel.py, all eleven tests: mesh construction, the
logical-axis rules (``spec_for`` equal to JAX's for the same rules), the
collectives' semantics, shard_params / init_sharded placement, and the
multi-slice layout.  Adds the collectives' other reductions, the
ppermute gradient against ``jax.grad``, the constraint and placement-order
rules, and ``sharded_paged_attention`` against the plain op.

The multi-rank checks run as gloo gangs (``parallel.gang.run_gang``: one
of 8 ranks and one of 4, file-store rendezvous, a 120 s deadline each);
their rank functions are in ``_torch_gang.py``.  The JAX side runs here on
the conftest's 8 virtual CPU devices.  Values are exact (the collectives
move f32 numbers and sum integers), the paged attention within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import _torch_gang as gang
from ray_tpu.parallel import LogicalAxisRules as JRules
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import ppermute_ring as jppermute
from ray_tpu_torch.parallel import (AXIS_ORDER, LogicalAxisRules, MeshSpec,
                                    slice_layout)

DEADLINE_S = 120


def _paged_inputs():
    rng = np.random.default_rng(0)
    B, N, NKV, Pg, page, H = 3, 16, 8, 6, 4, 8
    q = rng.standard_normal((B, N, H)).astype(np.float32)
    kp = rng.standard_normal((NKV, Pg, page, H)).astype(np.float32)
    vp = rng.standard_normal((NKV, Pg, page, H)).astype(np.float32)
    lengths = np.array([1, 7, 12], dtype=np.int64)
    table = np.array([[1, 0, 0], [2, 3, 0], [4, 5, 1]], dtype=np.int64)
    return [q, kp, vp, lengths, table]


@pytest.fixture(scope="module")
def world8():
    return gang.run(gang.parallel_world8, 8, (_paged_inputs(),),
                    timeout_s=DEADLINE_S)[0]


@pytest.fixture(scope="module")
def a2a_input():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 8)))


@pytest.fixture(scope="module")
def world4(a2a_input):
    return gang.run(gang.parallel_world4, 4, (a2a_input,),
                    timeout_s=DEADLINE_S)[0]


def test_mesh_spec_build(world8):
    spec = MeshSpec(dp=2, fsdp=2, tp=2)
    assert spec.num_devices == 8
    assert set(world8["names"]) == {"dp", "fsdp", "pp", "ep", "sp", "tp"}
    assert world8["names"] == AXIS_ORDER
    assert world8["sizes"]["dp"] == 2 and world8["sizes"]["tp"] == 2
    assert world8["sizes"]["pp"] == 1          # size-1 dims are kept
    assert "16 ranks" in world8["too_small"]


def test_mesh_for_devices_fills_dp():
    spec = MeshSpec.for_devices(8, tp=2, sp=2)
    assert spec.fsdp == 2 and spec.dp == 1
    spec = MeshSpec.for_devices(8, tp=2, fsdp=2)
    assert spec.dp == 2


def test_mesh_for_devices_indivisible():
    with pytest.raises(ValueError):
        MeshSpec.for_devices(8, tp=3)


LOGICAL = [("batch", "seq", "embed"), ("embed", "mlp"), (None, "heads", "kv"),
           ("batch", "heads", "seq", "kv"), ("layers", "embed", None, "heads",
                                             "kv"),
           ("layers", "expert", "embed", "mlp"), ("expert", "batch", None,
                                                  "embed"),
           ("vocab", "embed"), ("batch", None), ("norm",), (), (None, None)]


def test_logical_rules_spec():
    rules = LogicalAxisRules.for_transformer()
    assert rules.spec_for(("batch", "seq", "embed")) == (
        ("dp", "fsdp"), "sp")  # embed loses: fsdp already used by batch
    assert rules.spec_for(("embed", "mlp")) == ("fsdp", "tp")
    assert rules.spec_for((None, "heads", "kv")) == (None, "tp")
    # The same spec as JAX's, for every table and name tuple.
    custom = [("batch", "dp"), ("embed", ("fsdp", "tp")), ("mlp", "tp"),
              ("mlp", "fsdp"), ("heads", None)]
    for port, ref in ((rules, JRules.for_transformer()),
                      (LogicalAxisRules(custom), JRules(custom))):
        for axes in LOGICAL + [("mlp", "embed"), ("embed", "mlp", "heads")]:
            assert tuple(port.spec_for(axes)) == tuple(ref.spec_for(axes)), \
                axes


def test_collectives_semantics(world8):
    jm = jmake_mesh({"x": 8})
    want = np.asarray(jax.shard_map(
        lambda v: jppermute(v, "x"), mesh=jm, in_specs=JP("x"),
        out_specs=JP("x"), check_vma=False)(jnp.arange(8.0)))
    np.testing.assert_array_equal(world8["all_reduce_sum"], np.full(8, 28.0))
    np.testing.assert_array_equal(world8["all_reduce_mean"], np.full(8, 3.5))
    np.testing.assert_array_equal(world8["all_reduce_max"], np.full(8, 7.0))
    np.testing.assert_array_equal(world8["all_reduce_min"], np.zeros(8))
    np.testing.assert_array_equal(world8["all_gather"], np.arange(8.0))
    np.testing.assert_array_equal(world8["ppermute"], want)
    np.testing.assert_array_equal(world8["ppermute"],
                                  np.roll(np.arange(8.0), 1))
    assert world8["barrier"] == 28


def test_ppermute_grad_matches_jax(world8):
    jm = jmake_mesh({"x": 8})
    w = jnp.arange(8.0) ** 2

    def f(x):
        y = jax.shard_map(lambda v: jppermute(v, "x", shift=3), mesh=jm,
                          in_specs=JP("x"), out_specs=JP("x"),
                          check_vma=False)(x)
        return jnp.sum(y * w)

    np.testing.assert_array_equal(world8["ppermute_value"],
                                  np.roll(np.arange(8.0), 3))
    np.testing.assert_array_equal(world8["ppermute_grad"],
                                  np.asarray(jax.grad(f)(jnp.arange(8.0))))


def test_psum_scatter_matches_allreduce_slice(world4):
    total = np.arange(16.0).reshape(4, 4).sum(axis=0)
    np.testing.assert_array_equal(world4["psum_scatter"].ravel(), total)


def test_all_to_all_roundtrip(world4, a2a_input):
    np.testing.assert_allclose(world4["all_to_all"], a2a_input, rtol=1e-6)


@pytest.mark.parametrize("name", ["psum_scatter", "all_gather",
                                  "all_to_all", "all_reduce"])
def test_collective_grads_match_jax(world4, name):
    """Each differentiable collective's backward is the transpose JAX
    takes under shard_map (a [4, 4] input, one row a rank; the loss
    weighs the output's elements by index squared)."""
    from ray_tpu.parallel import (all_gather as jgather,
                                  all_reduce as jreduce,
                                  all_to_all as ja2a,
                                  psum_scatter as jscatter)
    fn = {"psum_scatter": lambda v: jscatter(v[0], "x")[None],
          "all_gather": lambda v: jgather(v[0], "x")[None],
          "all_to_all": lambda v: ja2a(v, "x", 1, 0),
          "all_reduce": lambda v: jreduce(v, "x")}[name]
    jm = jmake_mesh({"x": 4})

    def loss(x):
        y = jax.shard_map(fn, mesh=jm, in_specs=JP("x"), out_specs=JP("x"),
                          check_vma=False)(x)
        return jnp.sum(y * (jnp.arange(float(y.size)) ** 2).reshape(y.shape))

    want = np.asarray(jax.grad(loss)(jnp.arange(16.0).reshape(4, 4)))
    np.testing.assert_array_equal(world4[f"{name}_grad"], want)


def test_shard_params_places_leaves(world8):
    # w sharded (8/fsdp=2 rows, 16/tp=8 cols per rank)
    assert world8["w_local"] == (2, 8)
    assert world8["b_local"] == (8,)


def test_constraint_and_placement_order(world8):
    # ("batch", "mlp"): batch takes fsdp (dp is size 1), mlp tp
    assert world8["constraint_local"] == (2, 8)
    np.testing.assert_array_equal(world8["constraint_value"],
                                  np.arange(128.0).reshape(8, 16))
    assert world8["plain_passes"]
    assert "do not follow the mesh's order" in world8["order"]


def test_slice_mesh_single_process_layout():
    """slice_layout on one host: axes fold correctly and fsdp auto-fills.

    Virtual 'slices' partition one host's 8 ranks; with num_slices=2 the
    dp axis must enumerate slices as its outer factor, so each dp row is
    one contiguous rank block (the would-be NVLink domain)."""
    ranks, spec = slice_layout([list(range(8))], num_slices=2, tp=2)
    assert spec.dp == 2 and spec.tp == 2 and spec.fsdp == 2
    assert ranks.shape == (2, 2, 1, 1, 1, 2)
    assert sorted(ranks[0].flat) == list(range(4))
    assert sorted(ranks[1].flat) == list(range(4, 8))
    # two hosts: dp crosses them, the inner axes stay inside each
    from ray_tpu_torch.parallel import assert_slice_aligned
    hosts = [[4, 5, 6, 7], [0, 1, 2, 3]]
    ranks, _ = slice_layout(hosts, tp=2)
    assert_slice_aligned(ranks, hosts=hosts)
    with pytest.raises(AssertionError, match="spans hosts"):
        assert_slice_aligned(ranks, hosts=[[0, 1, 4, 5], [2, 3, 6, 7]])


def test_slice_mesh_rejects_bad_factoring():
    with pytest.raises(ValueError):
        slice_layout([list(range(8))], num_slices=3, tp=1)     # 8 % 3 != 0
    with pytest.raises(ValueError):
        slice_layout([list(range(8))], num_slices=2, tp=2, fsdp=4)


def test_init_sharded_matches_shard_params(world8):
    assert world8["same_placements"]
    np.testing.assert_array_equal(world8["init_sharded_w"],
                                  world8["shard_params_w"])


def test_sharded_paged_attention_matches_the_plain_op(world8):
    np.testing.assert_allclose(world8["paged"], world8["paged_plain"],
                               atol=1e-6, rtol=0)


def test_gang_fails_fast_and_keeps_its_deadline():
    """A rank that raises fails the gang without waiting out the deadline;
    a hang fails it at the deadline; either way every rank is killed."""
    import time
    with gang.one_gang_at_a_time():
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exited with code 1"):
            gang.run_gang(gang.fail_on_rank_1, 2, timeout_s=DEADLINE_S)
        # 30 s: rank 0 must spawn, import torch and pass the barrier
        # inside it (~4 s alone; over 10 s beside a loaded suite)
        with pytest.raises(TimeoutError,
                           match=r"ranks \[1\] still running"):
            gang.run_gang(gang.hang, 2, timeout_s=30)
        assert time.monotonic() - t0 < DEADLINE_S
