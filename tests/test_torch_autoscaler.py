"""Autoscaler: demand bin-packing, update() scale up/down, end-to-end elastic
scale-up on a real local cluster; the port's, case for case those of
``test_autoscaler.py``.

Reference analogs: python/ray/tests/test_autoscaler.py (MockProvider unit
tests) and test_autoscaler_fake_multinode.py (FakeMultiNodeProvider e2e).
The TPU slice type of the reference's case is a GPU machine type here.
This module imports nothing of JAX: the cluster's workers import it.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                NodeTypeConfig, ResourceDemandScheduler,
                                StandardAutoscaler, Monitor)
from ray_tpu_torch.autoscaler.node_provider import MockNodeProvider
from ray_tpu_torch.cluster_utils import Cluster


def test_demand_scheduler_packs_onto_existing_capacity():
    sched = ResourceDemandScheduler(
        [NodeTypeConfig("cpu4", {"CPU": 4.0})], max_workers=10)
    # 2 CPUs free on an existing node absorb two {CPU:1} demands.
    out = sched.get_nodes_to_launch(
        [{"CPU": 2.0}], [{"CPU": 1.0}, {"CPU": 1.0}], {})
    assert out == {}


def test_demand_scheduler_launches_bin_packed_nodes():
    sched = ResourceDemandScheduler(
        [NodeTypeConfig("cpu4", {"CPU": 4.0})], max_workers=10)
    out = sched.get_nodes_to_launch([], [{"CPU": 1.0}] * 10, {})
    assert out == {"cpu4": 3}  # ceil(10/4)


def test_demand_scheduler_respects_max_workers_and_infeasible():
    sched = ResourceDemandScheduler(
        [NodeTypeConfig("cpu4", {"CPU": 4.0}, max_workers=1)], max_workers=1)
    out = sched.get_nodes_to_launch([], [{"CPU": 4.0}] * 3, {})
    assert out == {"cpu4": 1}
    # A demand no node type can hold is dropped, not looped on.
    out = sched.get_nodes_to_launch([], [{"CPU": 64.0}], {})
    assert out == {}


def test_demand_scheduler_picks_gpu_type_for_gpu_demand():
    # A GPU machine is one node type: a GPU:8 demand must launch the GPU
    # type, while CPU-only demand takes the cheap type.
    sched = ResourceDemandScheduler(
        [NodeTypeConfig("cpu4", {"CPU": 4.0}),
         NodeTypeConfig("h100x8", {"CPU": 16.0, "GPU": 8.0})],
        max_workers=20)
    out = sched.get_nodes_to_launch(
        [], [{"GPU": 8.0}, {"CPU": 1.0}], {})
    # The CPU:1 demand packs onto the launched machine's spare host CPU.
    assert out == {"h100x8": 1}
    # With the GPU type exhausted, CPU demand falls to the cheap type.
    out = sched.get_nodes_to_launch(
        [], [{"GPU": 8.0}, {"CPU": 1.0}], {"h100x8": 10})
    assert out == {"cpu4": 1}


def test_min_workers_floor():
    sched = ResourceDemandScheduler(
        [NodeTypeConfig("cpu4", {"CPU": 4.0}, min_workers=2)])
    assert sched.min_workers_to_launch({}) == {"cpu4": 2}
    assert sched.min_workers_to_launch({"cpu4": 2}) == {}


def _mk_autoscaler(load, idle_timeout=0.0):
    provider = MockNodeProvider()
    cfg = AutoscalerConfig(
        node_types=[NodeTypeConfig("cpu4", {"CPU": 4.0})],
        idle_timeout_s=idle_timeout)
    return provider, StandardAutoscaler(provider, cfg, lambda: load)


def test_autoscaler_update_launches_on_shortfall():
    load = {"nodes": [], "pending_tasks": [{"CPU": 1.0}] * 6,
            "pending_actors": [], "pending_pg_bundles": []}
    provider, asc = _mk_autoscaler(load)
    launched = asc.update()
    assert launched == {"cpu4": 2}
    assert len(provider.non_terminated_nodes()) == 2
    # Next update: provider already has 2 pending nodes, but GCS still shows
    # no capacity -- the scheduler must not relaunch infinitely; counts cap
    # growth only via max_workers, so model registration by clearing demand.
    load["pending_tasks"] = []
    assert asc.update() == {}


def test_autoscaler_terminates_idle_nodes_after_timeout():
    provider = MockNodeProvider()
    cfg = AutoscalerConfig(
        node_types=[NodeTypeConfig("cpu4", {"CPU": 4.0})],
        idle_timeout_s=0.2)
    nid = provider.create_node(cfg.node_types[0], 1)[0]
    gcs_node = {"alive": True,
                "resources_total": {"CPU": 4.0},
                "resources_available": {"CPU": 4.0},
                "labels": {"rt-launch-id": nid}}
    load = {"nodes": [gcs_node], "pending_tasks": [],
            "pending_actors": [], "pending_pg_bundles": []}
    asc = StandardAutoscaler(provider, cfg, lambda: load)
    asc.update()
    assert provider.terminate_calls == []      # idle clock just started
    time.sleep(0.25)
    asc.update()
    assert provider.terminate_calls == [nid]   # past idle_timeout
    # Busy nodes are never reaped.
    nid2 = provider.create_node(cfg.node_types[0], 1)[0]
    gcs_node2 = dict(gcs_node, labels={"rt-launch-id": nid2},
                     resources_available={"CPU": 1.0})
    load["nodes"] = [gcs_node2]
    asc.update()
    time.sleep(0.25)
    asc.update()
    assert provider.terminate_calls == [nid]


def test_autoscaler_end_to_end_scales_up_for_queued_actor():
    """A queued actor (no feasible node) drives a real scale-up: the monitor
    sees the pending-actor demand in GCS load metrics, the LocalNodeProvider
    launches a daemon, and the actor schedules onto it."""
    cluster = Cluster(head_node_args={"num_cpus": 1})
    monitor = None
    try:
        ray_tpu_torch.init(address=cluster.address)
        provider = LocalNodeProvider(cluster)
        cfg = AutoscalerConfig(
            node_types=[NodeTypeConfig("cpu4", {"CPU": 4.0})],
            idle_timeout_s=3600)
        monitor = Monitor(provider, cfg, update_interval_s=0.5).start()

        @ray_tpu_torch.remote(num_cpus=4)
        class Big:
            def where(self):
                import os
                return os.environ.get("RT_NODE_ID")

        a = Big.remote()  # needs 4 CPUs; head has 1 -> queued -> scale up
        node_id = ray_tpu_torch.get(a.where.remote(), timeout=120)
        head_id = cluster.head_node.node_id
        assert node_id != head_id
        # The actor can run as soon as the new daemon registers with the
        # GCS, which precedes create_node() returning in the monitor
        # thread -- poll for the provider's bookkeeping to catch up.
        deadline = time.monotonic() + 30
        while not provider.non_terminated_nodes():
            assert time.monotonic() < deadline
            time.sleep(0.2)
    finally:
        if monitor:
            monitor.stop()
        ray_tpu_torch.shutdown()
        cluster.shutdown()


# ---------------------------------------------------------- launcher (up)

def test_cluster_launcher_yaml_up_down(tmp_path):
    """`ray_tpu_torch up` path: YAML -> ClusterConfig -> min_workers bootstrap
    -> monitor-driven demand scaling -> down terminates everything
    (reference: autoscaler/_private/commands.py create_or_update /
    teardown_cluster)."""
    import yaml as _yaml

    from ray_tpu_torch.autoscaler.launcher import (ClusterConfig,
                                                   ClusterLauncher)
    from ray_tpu_torch.autoscaler.node_provider import MockNodeProvider

    cfg_file = tmp_path / "cluster.yaml"
    cfg_file.write_text(_yaml.safe_dump({
        "cluster_name": "t",
        "max_workers": 6,
        "idle_timeout_s": 9999,   # no idle reaping during the test
        "provider": {"type": "mock"},
        "available_node_types": {
            "cpu_node": {"resources": {"CPU": 4}, "min_workers": 2,
                         "max_workers": 6},
        },
    }))
    cfg = ClusterConfig.from_file(str(cfg_file))
    assert cfg.node_types[0].min_workers == 2

    demands = []
    launcher = ClusterLauncher(
        cfg, provider=MockNodeProvider(),
        load_source=lambda: {"nodes": [], "pending_tasks": list(demands),
                             "pending_actors": [],
                             "pending_pg_bundles": []})
    launched = launcher.up(start_monitor=True)
    assert launched == {"cpu_node": 2}
    assert len(launcher.provider.non_terminated_nodes()) == 2

    # Demand beyond the floor: monitor must scale up.
    demands.extend([{"CPU": 4}] * 4)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and \
            len(launcher.provider.non_terminated_nodes()) < 3:
        time.sleep(0.2)
    assert len(launcher.provider.non_terminated_nodes()) >= 3

    n = launcher.down()
    assert n >= 3
    assert launcher.provider.non_terminated_nodes() == []


def test_cluster_config_validation(tmp_path):
    from ray_tpu_torch.autoscaler.launcher import ClusterConfig
    import pytest as _pytest
    with _pytest.raises(ValueError, match="missing 'provider'"):
        ClusterConfig.from_dict({"cluster_name": "x",
                                 "available_node_types": {}})
    with _pytest.raises(ValueError, match="unknown keys"):
        ClusterConfig.from_dict({
            "cluster_name": "x", "provider": {"type": "mock"},
            "available_node_types": {"a": {"resource": {}}}})


def test_request_resources_drives_scale_up():
    """autoscaler.sdk.request_resources: standing demand (no actual
    tasks) must scale the cluster up, and a cleared request stops
    fueling it (reference: autoscaler/sdk.py -> load_metrics
    resource_requests)."""
    from ray_tpu_torch.autoscaler.sdk import request_resources

    cluster = Cluster(head_node_args={"num_cpus": 1})
    monitor = None
    try:
        ray_tpu_torch.init(address=cluster.address)
        provider = MockNodeProvider()
        cfg = AutoscalerConfig(
            node_types=[NodeTypeConfig("cpu4", {"CPU": 4.0})],
            idle_timeout_s=3600)
        monitor = Monitor(provider, cfg, update_interval_s=0.3).start()

        request_resources(num_cpus=8)   # no tasks exist at all
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and \
                len(provider.non_terminated_nodes()) < 2:
            time.sleep(0.2)
        assert len(provider.non_terminated_nodes()) >= 2

        request_resources()             # clear
        n_after_clear = len(provider.non_terminated_nodes())
        time.sleep(1.5)
        assert len(provider.non_terminated_nodes()) == n_after_clear
    finally:
        if monitor:
            monitor.stop()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
