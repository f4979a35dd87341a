"""Central runtime configuration.

Design analog: reference ``src/ray/common/ray_config.h`` +
``ray_config_def.h`` (RAY_CONFIG flags, overridable per-process via
``RAY_<name>`` env vars and the ``_system_config`` dict passed to
``ray.init``, which is forwarded to every spawned daemon).

Resolution order (low to high): dataclass default < individual
``RT_<NAME>`` env var < ``RT_SYSTEM_CONFIG`` JSON blob / explicit
``apply_system_config`` (``ray_tpu_torch.init(_system_config=...)``).  The blob
outranks per-field env vars so a driver's ``_system_config`` resolves
identically in the driver and in every daemon/worker it spawns (the blob
is how the overrides propagate).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

SYSTEM_CONFIG_ENV = "RT_SYSTEM_CONFIG"


@dataclass
class RtConfig:
    # -- object plumbing --
    inline_max_bytes: int = 100 * 1024      # owner-inline object ceiling
    transfer_chunk_bytes: int = 4 * 1024 * 1024  # node-to-node pull frames
    push_inflight_chunks: int = 4           # per-link push pipelining cap
    # -- object data-plane integrity (crc32 stamped at seal time, carried
    #    through the directory, transfer frames, and the spill header;
    #    0 disables verification, not the stamping plumbing) --
    transfer_checksum: int = 1
    spill_fsync: int = 1                    # fsync spill file+dir pre-rename
    # Pull rounds: each round re-fetches locations from the GCS, so a
    # stale post-death view or a briefly-unreachable holder costs backoff
    # latency, not an ObjectLostError/lineage reconstruction.
    pull_retry_attempts: int = 3
    pull_retry_backoff_base_s: float = 0.2
    pull_retry_backoff_max_s: float = 2.0
    # -- control plane --
    heartbeat_period_s: float = 0.5
    health_timeout_s: float = 15.0          # missed-heartbeat death window
    # Cap on the lag-grace term added to health_timeout_s when the GCS's
    # own loop (or the node's, per its heartbeats) recently stalled: a
    # stalled control plane must not misread its own lag as node death,
    # but unbounded grace would mask genuinely dead nodes forever.
    health_lag_grace_max_s: float = 30.0
    # Event-loop watchdog (raylet + GCS): probe cadence and the stall
    # size that logs a warning with the offending-callback hint.
    loop_watchdog_interval_s: float = 0.25
    loop_watchdog_warn_s: float = 1.0
    # Control-plane partitions: a raylet/driver whose GCS conn drops keeps
    # redialing (exponential backoff + jitter, each dial deadline-bounded)
    # while the GCS holds the node DISCONNECTED for a resurrection grace
    # window — re-registration inside it costs zero actor restarts; only
    # grace expiry falls through to the normal death path.
    node_reconnect_grace_s: float = 30.0
    gcs_reconnect_backoff_base_s: float = 0.2
    gcs_reconnect_backoff_max_s: float = 5.0
    gcs_dial_timeout_s: float = 5.0
    gcs_snapshot_period_s: float = 1.0
    node_view_cache_s: float = 0.5          # spill/SPREAD scoring staleness
    task_event_retention: int = 20000
    # -- scheduling --
    max_spillback_hops: int = 8
    idle_worker_cap_per_shape: int = 8
    worker_start_timeout_s: float = 120.0
    lease_request_timeout_s: float = 600.0
    # -- forkserver (all deadlines are per-step, never block the loop) --
    forkserver_connect_timeout_s: float = 1.0   # unix connect deadline
    forkserver_spawn_timeout_s: float = 5.0     # request->pid reply deadline
    forkserver_boot_grace_s: float = 15.0       # template bind-or-bad window
    forkserver_backoff_base_s: float = 0.5      # template restart backoff
    forkserver_backoff_max_s: float = 30.0
    # -- memory management --
    spill_high_water: float = 0.8
    spill_low_water: float = 0.6
    memory_usage_threshold: float = 0.97
    memory_monitor_period_s: float = 1.0
    # -- retries --
    task_max_retries: int = 3
    actor_creation_attempts: int = 3
    # A task whose args don't resolve within this window fails RETRIABLY,
    # releasing its worker lease: consumers blocked on a lost object must
    # not hold every CPU while the reconstruction task starves for a lease
    # (resource deadlock; the reference resolves deps raylet-side before
    # dispatching to a worker).  Generous: cancellation restarts the fetch,
    # so the window must comfortably exceed legitimate large transfers.
    arg_resolution_timeout_s: float = 120.0
    # -- logging --
    log_poll_interval_s: float = 0.2        # worker log tail cadence

    @classmethod
    def _from_env(cls) -> "RtConfig":
        cfg = cls()
        for f in fields(cls):
            env = os.environ.get(f"RT_{f.name.upper()}")
            if env is not None:
                try:
                    setattr(cfg, f.name, type(getattr(cfg, f.name))(env))
                except (TypeError, ValueError):
                    pass
        # The blob wins over per-field env vars: it carries the driver's
        # _system_config, which must resolve the same in every process.
        blob = os.environ.get(SYSTEM_CONFIG_ENV)
        if blob:
            try:
                cfg._apply(json.loads(blob))
            except (json.JSONDecodeError, TypeError):
                pass
        return cfg

    def _apply(self, overrides: Dict[str, Any]):
        known = {f.name for f in fields(self)}
        unknown = set(overrides) - known
        if unknown:
            raise ValueError(
                f"unknown _system_config keys {sorted(unknown)}; known: "
                f"{sorted(known)}")
        for k, v in overrides.items():
            setattr(self, k, type(getattr(self, k))(v))


_config: Optional[RtConfig] = None


def config() -> RtConfig:
    global _config
    if _config is None:
        _config = RtConfig._from_env()
    return _config


def reset_config() -> None:
    """Drop the cached config so the next config() re-reads the
    environment.  Test hook: lets monkeypatched RT_* env vars take
    effect inside an already-imported process."""
    global _config
    _config = None


def apply_system_config(overrides: Optional[Dict[str, Any]]):
    """Apply ``ray_tpu_torch.init(_system_config=...)`` to this process AND
    export it so spawned daemons/workers inherit the same view (the
    reference serializes _system_config into the raylet/GCS command
    lines)."""
    if not overrides:
        return
    config()._apply(overrides)
    merged = {}
    blob = os.environ.get(SYSTEM_CONFIG_ENV)
    if blob:
        try:
            merged = json.loads(blob)
        except json.JSONDecodeError:
            merged = {}
    merged.update(overrides)
    os.environ[SYSTEM_CONFIG_ENV] = json.dumps(merged)
