"""Central config/flag system.

Reference analogs: src/ray/common/ray_config_def.h (RAY_CONFIG flags with
env + _system_config overrides forwarded to spawned daemons).

The port's runtime under ``test_config.py``'s cases, one for one.
"""

import json
import os
import subprocess
import sys

import pytest

from ray_tpu_torch._private.config import RtConfig, SYSTEM_CONFIG_ENV


def test_defaults_and_env_override(monkeypatch):
    monkeypatch.setenv("RT_INLINE_MAX_BYTES", "2048")
    monkeypatch.setenv("RT_SPILL_HIGH_WATER", "0.5")
    cfg = RtConfig._from_env()
    assert cfg.inline_max_bytes == 2048
    assert cfg.spill_high_water == 0.5
    assert cfg.health_timeout_s == 15.0  # untouched default


def test_system_config_env_blob(monkeypatch):
    monkeypatch.setenv(SYSTEM_CONFIG_ENV,
                       json.dumps({"task_max_retries": 7,
                                   "heartbeat_period_s": 0.25}))
    cfg = RtConfig._from_env()
    assert cfg.task_max_retries == 7
    assert cfg.heartbeat_period_s == 0.25


def test_blob_beats_individual_env(monkeypatch):
    """_system_config (the blob) outranks per-field env vars so a driver's
    overrides resolve identically in the driver and every spawned
    daemon/worker."""
    monkeypatch.setenv(SYSTEM_CONFIG_ENV,
                       json.dumps({"task_max_retries": 7}))
    monkeypatch.setenv("RT_TASK_MAX_RETRIES", "2")
    assert RtConfig._from_env().task_max_retries == 7
    # Env var still applies to fields the blob doesn't touch.
    monkeypatch.setenv("RT_HEALTH_TIMEOUT_S", "9.0")
    assert RtConfig._from_env().health_timeout_s == 9.0


def test_unknown_key_rejected():
    with pytest.raises(ValueError, match="unknown _system_config"):
        RtConfig()._apply({"not_a_flag": 1})


def test_system_config_propagates_to_workers():
    """init(_system_config=...) reaches worker processes (the reference
    forwards _system_config to every spawned daemon)."""
    script = r"""
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=1,
             _system_config={"inline_max_bytes": 12345})

@ray_tpu_torch.remote
def read_flag():
    from ray_tpu_torch._private.config import config
    return config().inline_max_bytes

from ray_tpu_torch._private.config import config
assert config().inline_max_bytes == 12345          # driver process
assert ray_tpu_torch.get(read_flag.remote()) == 12345    # worker process
print("CONFIG_PROPAGATED")
ray_tpu_torch.shutdown()
"""
    env = {k: v for k, v in os.environ.items() if k != SYSTEM_CONFIG_ENV}
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=180)
    assert "CONFIG_PROPAGATED" in r.stdout, r.stdout + r.stderr
