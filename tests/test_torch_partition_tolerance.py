"""Control-plane partition tolerance: reconnecting RPC clients, GCS
DISCONNECTED grace, idempotent node re-registration, location resync.

Reference analogs: src/ray/gcs/gcs_client reconnection + re-subscribe,
gcs_node_manager's node death handling, and
python/ray/tests/test_gcs_fault_tolerance.py (raylet survives GCS
restart and re-registers).  These are in-process tier-1 tests — the
subprocess/chaos versions live in tests/test_partition_chaos.py.

The port's runtime under ``test_partition_tolerance.py``'s cases, one for one.
"""

import asyncio
import time

import pytest

from ray_tpu_torch._private.config import reset_config
from ray_tpu_torch._private.gcs import ALIVE, RESTARTING, ActorInfo, GcsServer
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.protocol import (ConnectionLost, RpcServer, connect)
from ray_tpu_torch.util import fault_injection


@pytest.fixture()
def short_grace(monkeypatch):
    """Shrink the resurrection grace window so expiry tests run fast."""
    monkeypatch.setenv("RT_NODE_RECONNECT_GRACE_S", "0.5")
    reset_config()
    yield 0.5
    reset_config()


async def _noop(msg):
    return None


def _register_msg(node_id: NodeID, **extra) -> dict:
    return {"type": "register_node", "node_id": node_id.hex(),
            "address": "127.0.0.1:0", "store_name": f"rtt_test_{node_id.hex()[:6]}",
            "resources": {"CPU": 4.0}, **extra}


async def _wait_for(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"{what} not reached within {timeout}s")


# --------------------------------------------------- ReconnectingConnection

def test_reconnecting_connection_redials_and_fails_fast():
    async def main():
        calls = {"reconnect": 0, "disconnect": 0}

        def factory(conn):
            async def handler(msg):
                return {"echo": msg["x"]}
            return handler

        server = RpcServer(factory)
        port = await server.start(0)

        async def on_reconnect(rc):
            calls["reconnect"] += 1

        rc = await connect(
            f"127.0.0.1:{port}", _noop, name="test->srv", reconnect=True,
            backoff_base_s=0.05, backoff_max_s=0.2,
            on_reconnect=on_reconnect,
            on_disconnect=lambda _rc: calls.__setitem__(
                "disconnect", calls["disconnect"] + 1))
        assert (await rc.request({"x": 1}))["echo"] == 1

        # Sever from the server side; the client must notice, fail fast
        # while down, then redial on its own.
        await server.connections[0].close()
        await _wait_for(lambda: not rc.connected or rc.reconnects >= 1,
                        what="client noticed drop")
        if not rc.connected:
            with pytest.raises(ConnectionLost):
                await rc.request({"x": 2})
        await _wait_for(lambda: rc.connected and rc.reconnects >= 1,
                        what="redial")
        assert (await rc.request({"x": 3}))["echo"] == 3
        assert calls["reconnect"] >= 1 and calls["disconnect"] >= 1

        await rc.close()
        # Closed wrapper refuses traffic instead of redialing forever.
        with pytest.raises(ConnectionLost):
            await rc.request({"x": 4})
        await server.close()

    asyncio.run(main())


def test_partition_fault_window():
    fault_injection.set_spec(partition={"conn": "raylet->gcs",
                                        "after_s": 0.0, "heal_s": 0.3})
    try:
        # Non-matching connection names are never partitioned (and must
        # not anchor the window).
        assert not fault_injection.partition_active("worker->raylet")
        assert fault_injection.partition_window("worker->raylet") is None
        # First matching consult anchors the window; after_s=0 -> active.
        assert fault_injection.partition_active("raylet->gcs")
        start, end = fault_injection.partition_window("raylet->gcs")
        assert end is not None and end - start == pytest.approx(0.3)
        time.sleep(0.35)
        assert not fault_injection.partition_active("raylet->gcs")
    finally:
        fault_injection.clear_spec()


def test_partition_fault_permanent_window():
    fault_injection.set_spec(partition={"conn": "cw->gcs", "after_s": 0.0})
    try:
        assert fault_injection.partition_active("cw->gcs")
        _start, end = fault_injection.partition_window("cw->gcs")
        assert end is None
    finally:
        fault_injection.clear_spec()


# ------------------------------------------------------- GCS grace machine

def test_conn_close_attributes_to_owning_node(short_grace):
    """Dropping ONE node's conn marks only that node DISCONNECTED."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        na, nb = NodeID.from_random(), NodeID.from_random()
        conn_a = await connect(f"127.0.0.1:{port}", _noop, name="a->gcs")
        conn_b = await connect(f"127.0.0.1:{port}", _noop, name="b->gcs")
        assert (await conn_a.request(_register_msg(na)))["ok"]
        assert (await conn_b.request(_register_msg(nb)))["ok"]

        await conn_a.close()
        await _wait_for(
            lambda: gcs.nodes[na].disconnected_at is not None,
            what="node a DISCONNECTED")
        a, b = gcs.nodes[na], gcs.nodes[nb]
        assert a.alive and a.public()["state"] == "DISCONNECTED"
        assert not a.schedulable
        assert b.alive and b.disconnected_at is None and b.schedulable
        assert b.public()["state"] == "ALIVE"

        await conn_b.close()
        await gcs.close()

    asyncio.run(main())


def test_resurrect_within_grace_keeps_actors(short_grace):
    """Re-registration inside the grace window: same node record, actors
    keep their num_restarts, no dead event, no actor-failure storm."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        events = []
        sub = await connect(
            f"127.0.0.1:{port}",
            lambda msg: _record(events, msg), name="sub->gcs")
        await sub.request({"type": "subscribe", "channel": "nodes"})
        await sub.request({"type": "subscribe", "channel": "actors"})

        nid = NodeID.from_random()
        conn1 = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn1.request(_register_msg(nid)))["ok"]

        # An actor the GCS believes runs on the node, with restart history.
        aid = ActorID.from_random()
        gcs.actors[aid] = ActorInfo(
            actor_id=aid, name=None, namespace="default", state=ALIVE,
            creation_spec=b"", resources={"CPU": 1.0}, max_restarts=4,
            num_restarts=2, node_id=nid, address="127.0.0.1:7777")

        await conn1.close()
        await _wait_for(
            lambda: gcs.nodes[nid].disconnected_at is not None,
            what="DISCONNECTED")

        conn2 = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        reply = await conn2.request(_register_msg(
            nid, resources_available={"CPU": 3.0},
            actors=[{"actor_id": aid.hex(), "address": "127.0.0.1:7777"}]))
        assert reply["ok"] and reply.get("reconnected")

        node = gcs.nodes[nid]
        assert node.alive and node.disconnected_at is None
        assert node.conn is not None and node.schedulable
        assert node.reconnects == 1
        # Availability came from the raylet's report, not reset to totals.
        assert node.resources_available == {"CPU": 3.0}
        actor = gcs.actors[aid]
        assert actor.state == ALIVE and actor.num_restarts == 2

        await asyncio.sleep(0)  # let queued publishes flush
        kinds = [e["data"]["event"] for e in events
                 if e.get("channel") == "nodes"]
        assert "disconnected" in kinds and "reconnected" in kinds
        assert "dead" not in kinds
        # Grace expiry (well past the 0.5s window) must NOT fire now.
        await asyncio.sleep(0.8)
        assert gcs.nodes[nid].alive
        assert "dead" not in [e["data"]["event"] for e in events
                              if e.get("channel") == "nodes"]

        await conn2.close()
        await sub.close()
        await gcs.close()

    asyncio.run(main())


def test_resurrect_claims_restarting_actor_without_respawn(short_grace):
    """A snapshot-restored actor sitting RESTARTING in the pending queue
    is claimed by the reporting raylet, not scheduled a second time."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        nid = NodeID.from_random()
        conn1 = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn1.request(_register_msg(nid)))["ok"]

        aid = ActorID.from_random()
        gcs.actors[aid] = ActorInfo(
            actor_id=aid, name=None, namespace="default", state=RESTARTING,
            creation_spec=b"", resources={"CPU": 1.0}, max_restarts=-1,
            num_restarts=1, node_id=nid)
        gcs._pending_actor_queue.append(aid)

        await conn1.close()
        await _wait_for(
            lambda: gcs.nodes[nid].disconnected_at is not None,
            what="DISCONNECTED")
        conn2 = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        reply = await conn2.request(_register_msg(
            nid, actors=[{"actor_id": aid.hex(),
                          "address": "127.0.0.1:7778"}]))
        assert reply["ok"]
        actor = gcs.actors[aid]
        assert actor.state == ALIVE
        assert actor.num_restarts == 1            # no burned restart
        assert aid not in gcs._pending_actor_queue  # no duplicate spawn

        await conn2.close()
        await gcs.close()

    asyncio.run(main())


def test_register_reply_does_not_wait_for_a_pending_actor():
    """A node's registration is answered before the pending actor it
    makes feasible is created there: a GPU actor's cold start (torch
    import, CUDA init, weights) can outlast the health timeout, and the
    raylet starts its heartbeats only once its registration is answered,
    so a held reply would get the new node marked dead."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        aid = ActorID.from_random()
        gcs.actors[aid] = ActorInfo(
            actor_id=aid, name=None, namespace="default", state=RESTARTING,
            creation_spec=b"", resources={"GPU": 1.0}, max_restarts=1,
            num_restarts=1)
        gcs._pending_actor_queue.append(aid)
        created = asyncio.Event()

        async def raylet(msg):
            if msg.get("type") == "create_actor_worker":
                await asyncio.sleep(2.0)        # the cold start
                created.set()
                return {"address": "127.0.0.1:7779"}
            return None

        nid = NodeID.from_random()
        conn = await connect(f"127.0.0.1:{port}", raylet, name="raylet->gcs")
        t0 = time.monotonic()
        reply = await conn.request(_register_msg(
            nid, resources={"CPU": 4.0, "GPU": 1.0}))
        assert reply["ok"] and time.monotonic() - t0 < 1.0
        assert not created.is_set()
        await asyncio.wait_for(created.wait(), 10)
        await _wait_for(lambda: gcs.actors[aid].state == ALIVE,
                        what="actor ALIVE on the new node")
        assert gcs.actors[aid].node_id == nid

        await conn.close()
        await gcs.close()

    asyncio.run(main())


def test_grace_expiry_marks_dead(short_grace):
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        nid = NodeID.from_random()
        conn = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn.request(_register_msg(nid)))["ok"]
        await conn.close()
        await _wait_for(
            lambda: gcs.nodes[nid].disconnected_at is not None,
            what="DISCONNECTED")
        assert gcs.nodes[nid].alive
        await _wait_for(lambda: not gcs.nodes[nid].alive, timeout=5.0,
                        what="grace expiry death")
        assert gcs.nodes[nid].public()["state"] == "DEAD"
        await gcs.close()

    asyncio.run(main())


def test_dead_fold_counted_once_across_reregistration(short_grace):
    """Node dies (stats folded into dead totals), then the same node_id
    registers fresh: the folded entry is dropped exactly once and live
    stats take over — no double counting in the cluster totals."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        nid = NodeID.from_random()
        conn = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn.request(_register_msg(nid)))["ok"]
        await conn.request({"type": "report_node_stats",
                            "node_id": nid.hex(),
                            "stats": {"spilled_objects": 7,
                                      "gcs_reconnects": 3}})
        await gcs._mark_node_dead(gcs.nodes[nid])
        assert gcs.dead_spill_totals()["spilled_objects"] == 7
        assert gcs.dead_spill_totals()["gcs_reconnects"] == 3

        conn2 = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn2.request(_register_msg(nid)))["ok"]
        # The node resumed reporting its own lifetime counters; the folded
        # copy is gone (keeping it would count the same counters twice).
        assert gcs.dead_spill_totals()["spilled_objects"] == 0
        assert gcs.dead_spill_totals()["gcs_reconnects"] == 0

        await conn2.close()
        await gcs.close()

    asyncio.run(main())


def test_heartbeat_replies_not_ok_for_unknown_node():
    """A restarted (snapshot-less) GCS answers heartbeats of nodes it
    doesn't know with ok=False — the raylet's cue to re-register."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        conn = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        reply = await conn.request({"type": "heartbeat",
                                    "node_id": NodeID.from_random().hex()})
        assert reply == {"ok": False}
        nid = NodeID.from_random()
        assert (await conn.request(_register_msg(nid)))["ok"]
        reply = await conn.request({"type": "heartbeat",
                                    "node_id": nid.hex()})
        assert reply["ok"]
        await conn.close()
        await gcs.close()

    asyncio.run(main())


def test_resync_locations_accepts_unknown_objects():
    """resync_locations must create directory entries for ids the GCS has
    never seen (after a GCS restart EVERY id is unknown) — unlike
    object_spilled, whose refusal makes the raylet delete the file."""
    async def main():
        gcs = GcsServer()
        port = await gcs.start(0)
        nid = NodeID.from_random()
        conn = await connect(f"127.0.0.1:{port}", _noop, name="raylet->gcs")
        assert (await conn.request(_register_msg(nid)))["ok"]
        oid_mem, oid_disk = "aa" * 16, "bb" * 16
        reply = await conn.request({
            "type": "resync_locations", "node_id": nid.hex(),
            "objects": [oid_mem],
            "spilled": {oid_disk: "/tmp/spill/bb.bin"}})
        assert reply["ok"] and reply["count"] == 2
        nh = nid.hex()
        assert nh in gcs.object_dir[oid_mem].nodes
        assert gcs.object_dir[oid_disk].spilled[nh] == "/tmp/spill/bb.bin"
        # Idempotent: a second resync re-advertises without double entries.
        reply = await conn.request({
            "type": "resync_locations", "node_id": nid.hex(),
            "objects": [oid_mem], "spilled": {}})
        assert reply["ok"]
        assert gcs.object_dir[oid_mem].nodes == {nh}
        await conn.close()
        await gcs.close()

    asyncio.run(main())


async def _record(events, msg):
    if msg.get("type") == "pub":
        events.append(msg)
    return None
