"""Sharded checkpoints on torch.distributed.checkpoint (DCP), the port's
counterpart of the JAX package's orbax flavour.

The port's mirror of tests/test_orbax_checkpoint.py: a save and restore
round-trips SHARDED tensors (DTensors on a dp=2 x fsdp=2 x tp=2 mesh of 8
gloo ranks), each leaf keeping its placements through a restore into a
target, and the TorchCheckpoint envelope carries its meta (dp=8).  Both
cases run in one gang (``_torch_gang.dcp_world8``); values are held
exactly.
"""

import numpy as np
import pytest

import _torch_gang as gang


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dcp"))
    return gang.run(gang.dcp_world8, 8, (root,))[0]


def test_sharded_save_restore_roundtrip(world8):
    out = world8
    assert out["same_placements"] and out["w_local_equal"]
    want_w = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(out["w"], want_w)
    np.testing.assert_array_equal(out["b"], np.ones(8, np.float32))
    # Restore without a target (whole tensors) still round-trips values.
    assert out["flat_is_plain"]
    np.testing.assert_array_equal(out["flat_w"], want_w)


def test_torch_checkpoint_envelope(world8):
    assert world8["meta"]["step"] == 7
    np.testing.assert_array_equal(world8["p"],
                                  np.full((16, 4), 3.0, np.float32))
