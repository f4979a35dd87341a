"""AIR layer tests, the port's mirror of tests/test_air.py (reference:
python/ray/air/tests/test_checkpoints.py shape: dict<->dir round trips;
config validation).  Checkpoints hold nested dicts of torch tensors, bf16
included; ScalingConfig speaks whole cards."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.air import (Checkpoint, CheckpointConfig, FailureConfig,
                               RunConfig, ScalingConfig)


def test_checkpoint_dict_roundtrip(tmp_path):
    ckpt = Checkpoint.from_dict({"step": 7, "weights": [1, 2, 3]})
    d = ckpt.to_dict()
    assert d["step"] == 7

    path = ckpt.to_directory(str(tmp_path / "c1"))
    restored = Checkpoint.from_directory(path)
    d2 = restored.to_dict()
    assert d2 == d


def test_checkpoint_pytree_roundtrip(tmp_path):
    tree = {"layer": {"w": torch.ones((4, 4)), "b": torch.zeros(4),
                      "h": torch.arange(6, dtype=torch.bfloat16)},
            "scale": np.float32(2.0),
            "opt": {"state": {0: {"step": torch.tensor(3.0)}},
                    "param_groups": [{"lr": 3e-4, "betas": (0.9, 0.95),
                                      "params": [0]}]}}
    ckpt = Checkpoint.from_pytree(tree, step=3)
    path = ckpt.to_directory(str(tmp_path / "c2"))
    restored = Checkpoint.from_directory(path)
    out = restored.to_pytree()
    torch.testing.assert_close(out["layer"]["w"], torch.ones((4, 4)),
                               rtol=0, atol=0)
    # bf16 has no numpy dtype: it survives as raw bytes + its dtype name.
    assert out["layer"]["h"].dtype == torch.bfloat16
    assert torch.equal(out["layer"]["h"], tree["layer"]["h"])
    assert out["scale"] == np.float32(2.0)
    assert out["opt"]["state"][0]["step"].item() == 3.0
    assert out["opt"]["param_groups"][0]["betas"] == (0.9, 0.95)
    assert restored.to_dict()["step"] == 3


def test_checkpoint_bytes_and_pack(tmp_path):
    ckpt = Checkpoint.from_dict({"x": 1})
    assert Checkpoint.from_bytes(ckpt.to_bytes()).to_dict()["x"] == 1
    packed = ckpt.as_pack()
    assert Checkpoint.from_pack(packed).to_dict()["x"] == 1


def test_checkpoint_exactly_one_form():
    with pytest.raises(ValueError):
        Checkpoint()
    with pytest.raises(ValueError):
        Checkpoint(local_path="/tmp/x", data_dict={})


def test_scaling_config_bundles():
    sc = ScalingConfig(num_workers=4, use_gpu=True, gpus_per_worker=2)
    assert sc.bundle() == {"CPU": 1.0, "GPU": 2.0}
    assert sc.num_gpus_total == 8
    bundles = sc.as_placement_group_bundles()
    assert len(bundles) == 4
    assert ScalingConfig(num_workers=2, use_gpu=True).bundle() == {
        "CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(num_workers=2).num_gpus_total == 0


def test_run_config_defaults():
    rc = RunConfig()
    assert rc.failure_config.max_failures == 0
    assert rc.checkpoint_config.num_to_keep is None
    with pytest.raises(ValueError):
        CheckpointConfig(checkpoint_score_order="bogus")
    assert FailureConfig(max_failures=-1).max_failures == -1
