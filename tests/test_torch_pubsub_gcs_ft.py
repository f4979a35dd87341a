"""Pubsub channels + GCS snapshot fault tolerance.

Reference analogs: src/ray/pubsub (node/actor channels) and
python/ray/tests/test_gcs_fault_tolerance.py (head restart keeps durable
tables: KV, jobs, detached actors, placement groups).

The port's runtime under ``test_pubsub_gcs_ft.py``'s cases, one for one.
"""

import asyncio
import json
import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import pubsub


@pytest.fixture()
def ps_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_actor_lifecycle_events_published(ps_cluster):
    events = []
    got_dead = threading.Event()

    def on_actor(data):
        events.append(data)
        if data["event"] == "dead":
            got_dead.set()

    pubsub.subscribe("actors", on_actor)

    @ray_tpu_torch.remote
    class Ephemeral:
        def ping(self):
            return 1

    a = Ephemeral.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == 1
    ray_tpu_torch.kill(a)
    assert got_dead.wait(timeout=30), f"no dead event; saw {events}"
    kinds = {e["event"] for e in events}
    assert "alive" in kinds and "dead" in kinds


def test_node_events_published(ps_cluster):
    from ray_tpu_torch.cluster_utils import Cluster  # noqa: F401  (API parity)
    seen = []
    alive_evt = threading.Event()

    def on_node(data):
        seen.append(data)
        if data["event"] == "alive":
            alive_evt.set()

    pubsub.subscribe("nodes", on_node)
    # A fresh worker node joining publishes an 'alive' event.  Reuse the
    # running local cluster by registering a second daemon against it.
    from ray_tpu_torch._private.worker import get_core
    gcs_address = get_core().gcs_address
    import subprocess, sys, tempfile, uuid
    ready = os.path.join(tempfile.gettempdir(),
                         f"rtt_ps_{uuid.uuid4().hex[:6]}.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.daemon_main",
         "--ready-file", ready, "--gcs-address", gcs_address,
         "--resources", json.dumps({"CPU": 1.0}), "--no-gpu-detect"])
    try:
        assert alive_evt.wait(timeout=60), "no node-alive event"
    finally:
        proc.terminate()
        proc.wait()


def test_gcs_snapshot_restart_preserves_durable_state(tmp_path):
    """Run a GcsServer with a persist path, mutate durable tables, close,
    reopen: KV, jobs, and detached-actor records survive."""
    from ray_tpu_torch._private.gcs import GcsServer
    from ray_tpu_torch._private.protocol import connect

    path = str(tmp_path / "gcs.json")

    async def phase1():
        gcs = GcsServer(persist_path=path)
        port = await gcs.start(0)

        async def noop(msg):
            return None

        conn = await connect(f"127.0.0.1:{port}", noop)
        await conn.request({"type": "kv_put", "ns": "t", "key": b"k",
                            "value": b"v1"})
        await conn.request({"type": "register_job", "job_id": "j1"})
        await conn.close()
        await gcs.close()

    async def phase2():
        gcs = GcsServer(persist_path=path)
        port = await gcs.start(0)

        async def noop(msg):
            return None

        conn = await connect(f"127.0.0.1:{port}", noop)
        v = await conn.request({"type": "kv_get", "ns": "t", "key": b"k"})
        jobs = await conn.request({"type": "get_jobs"})
        await conn.close()
        await gcs.close()
        return v, jobs

    asyncio.run(phase1())
    assert os.path.exists(path)
    v, jobs = asyncio.run(phase2())
    assert v == b"v1"
    assert any(j["job_id"] == "j1" for j in jobs)
