"""Fault-injection harness tests (ray_tpu_torch/util/fault_injection.py).

Unit half: spec parsing and the RPC frame-drop filter are deterministic
and process-local.  Cluster half (slow+chaos): the injection points in
real daemons — wedged forkserver template, delayed heartbeats, NodeKiller
— and the control-plane property this PR exists for: a spawn storm
against a wedged template must not stall the raylet loop long enough for
the GCS to declare the node dead.

The port's runtime under ``test_fault_injection.py``'s cases, one for one.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import fault_injection


# ------------------------------------------------------------------ unit

def test_spec_roundtrip_through_env(monkeypatch):
    env = fault_injection.env_for(
        forkserver={"mode": "slow", "delay_s": 1.5},
        heartbeat_delay_s=2.0,
        drop_rpc={"conn": "gcs", "every": 3})
    monkeypatch.setenv(fault_injection.ENV_VAR,
                       env[fault_injection.ENV_VAR])
    fault_injection.clear_spec()
    try:
        assert fault_injection.forkserver_fault() == ("slow", 1.5)
        assert fault_injection.heartbeat_delay_s() == 2.0
        assert fault_injection.spec().drop_rpc == {"conn": "gcs",
                                                   "every": 3}
    finally:
        fault_injection.clear_spec()


def test_spec_defaults_and_bad_json(monkeypatch):
    monkeypatch.delenv(fault_injection.ENV_VAR, raising=False)
    fault_injection.clear_spec()
    assert fault_injection.forkserver_fault() == ("", 0.0)
    assert fault_injection.heartbeat_delay_s() == 0.0
    monkeypatch.setenv(fault_injection.ENV_VAR, "{not json")
    fault_injection.clear_spec()
    try:
        assert fault_injection.forkserver_fault() == ("", 0.0)
    finally:
        fault_injection.clear_spec()


def test_wedge_string_shorthand(monkeypatch):
    monkeypatch.setenv(
        fault_injection.ENV_VAR,
        fault_injection.env_for(forkserver="wedge")[
            fault_injection.ENV_VAR])
    fault_injection.clear_spec()
    try:
        assert fault_injection.forkserver_fault() == ("wedge", 0.0)
    finally:
        fault_injection.clear_spec()


class _FakeConn:
    def __init__(self, name):
        self.name = name


def test_make_drop_filter_every_nth_per_connection():
    f = fault_injection.make_drop_filter("raylet", every=3)
    a, b = _FakeConn("raylet-1"), _FakeConn("raylet-2")
    other = _FakeConn("gcs-client")
    # every 3rd frame per connection, counters independent
    assert [f(a, b"x") for _ in range(6)] == [False, False, True,
                                             False, False, True]
    assert [f(b, b"x") for _ in range(3)] == [False, False, True]
    # non-matching connection names never drop (and don't count)
    assert [f(other, b"x") for _ in range(10)] == [False] * 10


def test_drop_filter_installs_into_protocol(monkeypatch):
    """The env spec auto-installs a frame fault the first time an
    RpcConnection is built in the process (daemon path)."""
    from ray_tpu_torch._private import protocol
    monkeypatch.setenv(
        fault_injection.ENV_VAR,
        fault_injection.env_for(drop_rpc={"conn": "nope", "every": 2})[
            fault_injection.ENV_VAR])
    fault_injection.clear_spec()
    old_fault = protocol._frame_fault
    old_checked = protocol._env_fault_checked
    protocol._frame_fault = None
    protocol._env_fault_checked = False
    try:
        protocol._maybe_install_env_fault()
        assert protocol._frame_fault is not None
    finally:
        protocol.set_frame_fault(old_fault)
        protocol._env_fault_checked = old_checked
        fault_injection.clear_spec()


def test_lease_queued_behind_dying_actor_dispatches_on_reap():
    """Regression: a task lease queued while a doomed actor still held the
    node's CPUs must be granted when the reap returns them.  kill() only
    signals the worker process — the reap loop is the actual release
    point — and it used to hand the resources back without re-running
    lease dispatch, so the lease sat forever on a node with free capacity
    (surfaced as joblib/Pool workloads freezing mid-suite)."""
    ray_tpu_torch.init(num_cpus=1)
    try:

        @ray_tpu_torch.remote(num_cpus=1)
        class Hog:
            def ping(self):
                return "up"

        hog = Hog.remote()
        assert ray_tpu_torch.get(hog.ping.remote()) == "up"

        @ray_tpu_torch.remote(num_cpus=1)
        def after():
            return 42

        ref = after.remote()    # queues: the actor holds the only CPU
        time.sleep(1.0)         # let the lease reach the raylet and queue
        ray_tpu_torch.kill(hog)
        # Must resolve well inside the 20s stuck-lease watchdog period:
        # only the reap-path dispatch can be what granted it.
        assert ray_tpu_torch.get(ref, timeout=15) == 42
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------------------------------------- cluster

@pytest.mark.slow
@pytest.mark.chaos
def test_spawn_storm_survives_wedged_template():
    """THE regression this PR pins: 50 concurrent spawns on a node whose
    forkserver template accepts connections but never replies.  The old
    synchronous client blocked the raylet loop per spawn; heartbeats
    stopped; the GCS declared a healthy node dead.  Now every task must
    complete (cold-spawn fallback), the node must stay alive, and the
    raylet's observed loop lag must stay far below the health timeout."""
    cluster = Cluster(head_node_args={"num_cpus": 1})
    storm_node = cluster.add_node(
        num_cpus=50, resources={"storm": 50.0},
        env=fault_injection.env_for(forkserver="wedge"))
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()

        @ray_tpu_torch.remote(resources={"storm": 1.0}, num_cpus=1)
        def who():
            time.sleep(1.0)      # hold the worker: forces 50 live spawns
            return os.getpid()

        t0 = time.monotonic()
        pids = ray_tpu_torch.get([who.remote() for _ in range(50)],
                                 timeout=600)
        storm_s = time.monotonic() - t0

        assert len(pids) == 50
        assert len(set(pids)) == 50          # 50 distinct workers spawned
        # the wedged node survived the storm
        rec = {n["node_id"]: n for n in ray_tpu_torch.nodes()}
        assert rec[storm_node.node_id]["alive"], (
            f"storm node declared dead during a {storm_s:.0f}s storm")
        # observed raylet loop lag stayed below the GCS health timeout
        from ray_tpu_torch.util import state
        from ray_tpu_torch._private.config import config
        deadline = time.monotonic() + 20
        stats = {}
        while time.monotonic() < deadline:
            stats = state.node_stats().get(storm_node.node_id, {})
            if "loop_lag_max_ms" in stats:
                break
            time.sleep(0.5)
        assert "loop_lag_max_ms" in stats, "no loop lag in node stats"
        assert stats["loop_lag_max_ms"] < config().health_timeout_s * 1000
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_delayed_heartbeat_marks_node_dead():
    """A node whose heartbeats are delayed past the health timeout is
    declared dead by the GCS even though its process is running — the
    health check keys on heartbeat recency, and the lag grace must NOT
    excuse genuinely silent nodes."""
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "env": {"RT_HEALTH_TIMEOUT_S": "3"}})
    victim = cluster.add_node(
        num_cpus=1,
        env=fault_injection.env_for(heartbeat_delay_s=30))
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()
        rec = fault_injection.wait_node_dead(victim.node_id, timeout=60)
        assert not rec["alive"]
        # the daemon process itself is still up: death was injected,
        # not a crash
        assert victim.proc.poll() is None
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_node_killer_actor_kills_and_observes():
    """NodeKiller as a cluster actor (reference NodeKillerActor): kills a
    non-head node by registered pid and returns only after the GCS
    recorded the death."""
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "resources": {"head_zone": 1.0},
        "env": {"RT_HEALTH_TIMEOUT_S": "5"}})
    worker = cluster.add_node(num_cpus=1)
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()

        Killer = ray_tpu_torch.remote(fault_injection.NodeKiller)
        # pin to the head so the killer survives its own kill
        killer = Killer.options(resources={"head_zone": 0.001}).remote()
        alive = ray_tpu_torch.get(killer.alive_nodes.remote(), timeout=60)
        assert [n["node_id"] for n in alive] == [worker.node_id]

        rec = ray_tpu_torch.get(killer.kill_node.remote(), timeout=120)
        assert rec["node_id"] == worker.node_id
        nodes = {n["node_id"]: n for n in ray_tpu_torch.nodes()}
        assert not nodes[worker.node_id]["alive"]
        # head was never a candidate
        assert nodes[cluster.head_node.node_id]["alive"]
        killed = ray_tpu_torch.get(killer.killed_nodes.remote(), timeout=60)
        assert [k["node_id"] for k in killed] == [worker.node_id]
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
