"""The raylet's lease-wait report (ROADMAP C12): when a lease has waited
longer than ``lease_wait_log_s``, the raylet logs which leases and workers
hold the node's resources, and keeps the report in its node stats.

The cluster case shows the mechanism the report was added to see: a task
is leased before its arguments exist (the core worker leases first and the
executing worker resolves the arguments, as the reference's does), so it
holds its CPU in the ``args`` phase while a second task waits for that CPU.

This module imports no JAX and nothing of ``ray_tpu``: the cluster's
workers import it.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.raylet import lease_wait_report
from ray_tpu_torch.util import state


def test_lease_wait_report_format():
    holders = [
        {"kind": "actor", "actor": "a" * 12, "pid": 3,
         "resources": {"CPU": 1.0}},
        {"kind": "lease", "worker": "w" * 12, "pid": 1,
         "resources": {"CPU": 1.0}, "held_s": 2.5, "blocked": False,
         "task": "consumer", "phase": "args"},
        {"kind": "lease", "worker": "v" * 12, "pid": 2,
         "resources": {"CPU": 1.0}, "held_s": 11.25, "blocked": False,
         "task": "partition", "phase": "running"},
    ]
    rep = lease_wait_report(10.123456, {"CPU": 1.0}, 2, {"CPU": 0.0},
                            holders)
    assert set(rep) == {"waited_s", "wants", "pending", "available",
                        "holders"}
    assert rep["waited_s"] == 10.123
    assert rep["wants"] == {"CPU": 1.0} and rep["pending"] == 2
    assert rep["available"] == {"CPU": 0.0}
    # the longest held first; an actor (no held_s) last
    assert [h["pid"] for h in rep["holders"]] == [2, 1, 3]


@ray_tpu_torch.remote(num_cpus=0)
class Gate:
    def value(self, delay):
        time.sleep(delay)
        return 7


@ray_tpu_torch.remote
def consumer(x):
    return x + 1


@ray_tpu_torch.remote
def waiter():
    return "ran"


def test_lease_held_while_its_args_resolve_is_reported(monkeypatch):
    monkeypatch.setenv("RT_LEASE_WAIT_LOG_S", "1.0")
    monkeypatch.setenv("RT_NODE_STATS_INTERVAL_S", "0.5")
    ray_tpu_torch.init(num_cpus=1)
    try:
        gate = Gate.remote()
        ray_tpu_torch.get(gate.value.remote(0.0))      # the actor is up
        held = consumer.remote(gate.value.remote(4.0))  # leases the CPU now
        time.sleep(0.5)
        queued = waiter.remote()                       # waits for the CPU
        assert ray_tpu_torch.get([held, queued], timeout=60) == [8, "ran"]
        deadline = time.monotonic() + 20
        reports = []
        while time.monotonic() < deadline and not reports:
            reports = [r for s in state.node_stats().values()
                       for r in s.get("lease_waits", [])]
            time.sleep(0.25)
    finally:
        ray_tpu_torch.shutdown()
    assert reports, "no lease-wait report reached the node stats"
    rep = reports[0]
    assert rep["waited_s"] > 1.0 and rep["wants"] == {"CPU": 1.0}
    assert rep["available"].get("CPU", 0.0) == pytest.approx(0.0)
    leases = [h for h in rep["holders"] if h["kind"] == "lease"]
    assert [(h["task"], h["phase"]) for h in leases] == [("consumer",
                                                           "args")]
    assert leases[0]["resources"] == {"CPU": 1.0} and leases[0]["held_s"] > 1
