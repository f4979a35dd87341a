"""GCS: the cluster metadata authority and control plane.

Design analog: reference ``src/ray/gcs/gcs_server/`` -- GcsServer, GcsNodeManager,
GcsActorManager (+ GcsActorScheduler with restart-on-failure), GcsJobManager,
GcsPlacementGroupManager/Scheduler, GcsResourceManager, GcsHealthCheckManager,
GcsKvManager, pubsub Publisher.  One GCS per cluster, running on the head node
daemon process; node daemons hold a persistent duplex connection to it, so the
GCS can push work (actor creation, bundle reservation) down the same channel
daemons use to heartbeat -- functionally the reference's gRPC service pairs.

Like the reference (in_memory_store_client.h default), state is in-memory with
an optional JSON snapshot for head restart (GCS fault tolerance analog of the
Redis-backed gcs_table_storage).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.async_utils import spawn
from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID
from ray_tpu_torch._private.protocol import RpcConnection, RpcServer

logger = logging.getLogger(__name__)

import os as _os

from ray_tpu_torch._private.config import config as _rt_config


def _heartbeat_period() -> float:
    return _rt_config().heartbeat_period_s


def _health_timeout() -> float:
    # Generous by default (reference health_check_timeout_ms=30s): on
    # small/1-core hosts a worker's jax import can starve daemons for
    # seconds at a time.
    return _rt_config().health_timeout_s

# Actor lifecycle states (reference: gcs_actor_manager.h / rpc::ActorTableData)
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str           # node daemon rpc address
    store_name: str        # shm object store segment name
    resources_total: Dict[str, float]
    resources_available: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    conn: Optional[RpcConnection] = None
    is_head: bool = False
    # Unsatisfied lease shapes last reported by the raylet (autoscaler input).
    pending_demand: List[Dict[str, float]] = field(default_factory=list)
    # Daemon process pid (chaos tooling: util/fault_injection NodeKiller).
    pid: int = 0
    # Worst recent event-loop lag the raylet reported with its last
    # heartbeat (seconds); feeds the per-node health grace.
    reported_lag_s: float = 0.0
    # Control-plane partition state: set when the node's conn dropped but
    # the resurrection grace window (node_reconnect_grace_s) is still
    # open.  The node stays alive (its workers/objects keep running on
    # the far side of the partition) but is not schedulable; re-register
    # clears it, grace expiry hands over to _mark_node_dead.
    disconnected_at: Optional[float] = None
    grace_task: Optional[asyncio.Task] = None
    reconnects: int = 0

    @property
    def schedulable(self) -> bool:
        # getattr: test harnesses stub conn with fakes that lack .closed.
        return (self.alive and self.conn is not None
                and not getattr(self.conn, "closed", False))

    def public(self) -> dict:
        state = "DEAD" if not self.alive else (
            "DISCONNECTED" if self.disconnected_at is not None else "ALIVE")
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "store_name": self.store_name,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "labels": self.labels,
            "alive": self.alive,
            "state": state,
            "is_head": self.is_head,
            "pid": self.pid,
        }


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: str
    # Serialized actor creation spec (class ref, args, options) -- opaque to GCS.
    creation_spec: bytes
    resources: Dict[str, float]
    max_restarts: int
    num_restarts: int = 0
    address: Optional[str] = None
    node_id: Optional[NodeID] = None
    owner_job: Optional[str] = None
    detached: bool = False
    death_cause: Optional[str] = None
    scheduling: dict = field(default_factory=dict)
    # {method_name: num_returns} from @ray_tpu_torch.method decorators; served
    # with get_named_actor so get_actor() handles honor return arity.
    method_meta: dict = field(default_factory=dict)
    waiters: List[asyncio.Future] = field(default_factory=list)
    creation_attempts: int = 0  # spawn-failure retries (not user restarts)

    def public(self) -> dict:
        return {
            "actor_id": self.actor_id.hex(),
            "name": self.name,
            "method_meta": self.method_meta,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id.hex() if self.node_id else None,
            "num_restarts": self.num_restarts,
            "max_restarts": self.max_restarts,
            "resources": self.resources,
            "death_cause": self.death_cause,
        }


@dataclass
class ObjectDirEntry:
    """Object directory record: in-memory copies + spilled-to-disk copies
    (reference: OwnershipBasedObjectDirectory + LocalObjectManager spilled
    URLs, local_object_manager.h:41)."""
    owner: str
    nodes: Set[str] = field(default_factory=set)
    spilled: Dict[str, str] = field(default_factory=dict)  # node hex -> path
    size: int = 0          # bytes (locality-aware lease weighting)
    # Seal-time crc32 stamped by the creator; pullers/pushers verify a
    # transferred copy against it before sealing (None for objects that
    # predate stamping or were created with transfer_checksum=0).
    checksum: Optional[int] = None


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str
    state: str = "PENDING"  # PENDING / CREATED / REMOVED
    # bundle index -> node_id
    allocations: Dict[int, NodeID] = field(default_factory=dict)
    waiters: List[asyncio.Future] = field(default_factory=list)
    # Re-entrancy guard: heartbeat- and register-triggered retries must not
    # double-reserve bundles while a reservation round-trip is in flight.
    scheduling_in_progress: bool = False

    def public(self) -> dict:
        return {
            "placement_group_id": self.pg_id.hex(),
            "bundles": self.bundles,
            "strategy": self.strategy,
            "state": self.state,
            "allocations": {i: n.hex() for i, n in self.allocations.items()},
        }


class GcsServer:
    """In-process asyncio GCS. Started by the head node daemon."""

    def __init__(self, persist_path: Optional[str] = None):
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.jobs: Dict[str, dict] = {}
        # object_id hex -> (owner address, set of node hexes with a copy)
        self.object_dir: Dict[str, ObjectDirEntry] = {}
        self.subscribers: Dict[str, List[RpcConnection]] = {}
        from collections import deque
        self.task_events: "deque" = deque(maxlen=_rt_config().task_event_retention)
        self.metrics: Dict[tuple, dict] = {}
        # node_id hex -> latest per-node agent report (workers, load, mem,
        # object store); feeds /api/node_stats and pid->node routing for
        # the profiler.  Ephemeral by design (like resource views).
        self.node_stats: Dict[str, dict] = {}
        # Spill/restore counts carried over from DEAD nodes so
        # spill_totals() stays a true lifetime total (a dead node's live
        # stats entry is dropped below).  Keyed by node id: the raylet
        # reports LIFETIME counters, so folding the same node twice
        # (die -> re-register after a transient partition -> die again)
        # must overwrite its entry, not add to a global sum — and a
        # re-registration drops the entry outright because the live node
        # resumes reporting the same lifetime counters itself.
        self._dead_spill_totals: Dict[str, Dict[str, int]] = {}
        # Corruption strikes per node (checksum-mismatch invalidations
        # reported against it) — the data-plane health signal the
        # dashboard exports per node id.  Survives the node's death (a
        # node that served garbage and died is still part of the story).
        self.object_invalidations: Dict[str, int] = {}
        self.server = RpcServer(self._make_handler)
        self._persist_path = persist_path
        self._watchdog = None   # LoopWatchdog, created in start()
        self._health_task: Optional[asyncio.Task] = None
        self._snapshot_task: Optional[asyncio.Task] = None
        self._dirty = False
        self._pending_actor_queue: List[ActorID] = []

    async def start(self, port: int = 0) -> int:
        if self._persist_path:
            # Read + parse on the executor (a large KV snapshot would
            # stall the loop before it even serves); apply on the loop.
            snap = await asyncio.get_running_loop().run_in_executor(
                None, self._read_snapshot_file)
            if snap is not None:
                self._apply_snapshot(snap)
        port = await self.server.start(port)
        # The health verdict below compares heartbeat age against a
        # timeout — but heartbeats are PROCESSED on this loop, so our own
        # lag inflates every age.  The watchdog measures that lag; the
        # health check credits it back as grace.
        from ray_tpu_torch._private.loop_watchdog import LoopWatchdog
        self._watchdog = LoopWatchdog("gcs")
        self._watchdog.start()
        self._health_task = asyncio.get_running_loop().create_task(self._health_loop())
        if self._persist_path:
            self._snapshot_task = asyncio.get_running_loop().create_task(
                self._snapshot_loop())
        return port

    async def close(self):
        self._closing = True
        if getattr(self, "_watchdog", None) is not None:
            self._watchdog.stop()
        if self._health_task:
            self._health_task.cancel()
        if self._snapshot_task:
            self._snapshot_task.cancel()
        if self._persist_path:
            try:
                await self._write_snapshot_async()
            except Exception:
                logger.exception("final GCS snapshot failed")
        await self.server.close()

    # ------------------------------------------------- snapshot persistence

    def _snapshot_state(self) -> dict:
        """Durable cluster metadata (reference: gcs_table_storage.h:252 —
        the tables that survive a head restart via Redis).  Runtime state
        (node connections, leases, object locations) re-forms when raylets
        reconnect and is deliberately not persisted."""
        import base64
        b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
        return {
            "kv": {ns: {b64(k): b64(v) for k, v in table.items()}
                   for ns, table in self.kv.items()},
            "jobs": self.jobs,
            "named_actors": [
                [ns, name, aid.hex()]
                for (ns, name), aid in self.named_actors.items()
                if aid in self.actors and self.actors[aid].state != DEAD],
            "actors": [
                {"actor_id": a.actor_id.hex(), "name": a.name,
                 "namespace": a.namespace,
                 "creation_spec": b64(a.creation_spec),
                 "resources": a.resources, "max_restarts": a.max_restarts,
                 "num_restarts": a.num_restarts, "detached": a.detached,
                 "scheduling": a.scheduling,
                 "method_meta": a.method_meta}
                # DEAD stays dead across restarts: a ray.kill'ed detached
                # actor must not resurrect from the snapshot.
                for a in self.actors.values()
                if a.detached and a.state != DEAD],
            "placement_groups": [
                {"pg_id": pg.pg_id.hex(), "bundles": pg.bundles,
                 "strategy": pg.strategy}
                for pg in self.placement_groups.values()
                if pg.state != "REMOVED"],
        }

    async def _write_snapshot_async(self):
        """Snapshot without stalling the event loop: the state dict is
        built synchronously (no awaits — consistent view), but the JSON
        encode + disk write of a potentially-large KV run on the executor."""
        state = self._snapshot_state()
        self._dirty = False

        def _dump():
            tmp = self._persist_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
                f.flush()
                _os.fsync(f.fileno())
            _os.replace(tmp, self._persist_path)

        await asyncio.get_running_loop().run_in_executor(None, _dump)

    def _read_snapshot_file(self) -> Optional[dict]:
        """File IO half of snapshot restore — runs on the executor so a
        large snapshot never stalls the serving loop (see start())."""
        try:
            with open(self._persist_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _apply_snapshot(self, snap: dict):
        import base64
        ub = base64.b64decode
        self.kv = {ns: {ub(k): ub(v) for k, v in table.items()}
                   for ns, table in snap.get("kv", {}).items()}
        self.jobs = snap.get("jobs", {})
        # Detached actors restart from their persisted creation spec once
        # nodes re-register (same path as restart-on-node-death).
        for rec in snap.get("actors", []):
            actor = ActorInfo(
                actor_id=ActorID.from_hex(rec["actor_id"]),
                name=rec["name"], namespace=rec["namespace"],
                state=RESTARTING,
                creation_spec=ub(rec["creation_spec"]),
                resources=rec["resources"],
                max_restarts=rec["max_restarts"],
                num_restarts=rec["num_restarts"],
                detached=True, scheduling=rec.get("scheduling", {}),
                method_meta=rec.get("method_meta", {}))
            self.actors[actor.actor_id] = actor
            self._pending_actor_queue.append(actor.actor_id)
        for ns, name, aid in snap.get("named_actors", []):
            self.named_actors[(ns, name)] = ActorID.from_hex(aid)
        for rec in snap.get("placement_groups", []):
            pg = PlacementGroupInfo(
                pg_id=PlacementGroupID.from_hex(rec["pg_id"]),
                bundles=rec["bundles"], strategy=rec["strategy"],
                state="PENDING")
            self.placement_groups[pg.pg_id] = pg
        logger.info("GCS restored snapshot from %s (%d kv namespaces, "
                    "%d detached actors, %d pgs)", self._persist_path,
                    len(self.kv), len(snap.get("actors", [])),
                    len(snap.get("placement_groups", [])))

    async def _snapshot_loop(self):
        while True:
            await asyncio.sleep(_rt_config().gcs_snapshot_period_s)
            if not self._dirty:
                continue
            try:
                await self._write_snapshot_async()
            except Exception:
                logger.exception("GCS snapshot write failed")

    def _mark_dirty(self):
        self._dirty = True

    # ------------------------------------------------------------------ rpc

    # Message types that change durable state (snapshot triggers).
    _DURABLE_MUTATIONS = frozenset({
        "kv_put", "kv_del", "create_actor", "kill_actor",
        "report_actor_death", "register_job", "finish_job",
        "create_placement_group", "remove_placement_group"})

    def _make_handler(self, conn: RpcConnection):
        async def handle(msg: dict):
            mtype = msg["type"]
            fn = getattr(self, f"_h_{mtype}", None)
            if fn is None:
                raise ValueError(f"gcs: unknown message type {mtype}")
            result = await fn(conn, msg)
            if mtype in self._DURABLE_MUTATIONS:
                self._dirty = True
            return result

        conn.on_close = self._on_conn_close
        return handle

    def _on_conn_close(self, conn: RpcConnection):
        for subs in self.subscribers.values():
            if conn in subs:
                subs.remove(conn)
        if getattr(self, "_closing", False):
            return   # clean shutdown closes every conn; nothing "died"
        for node in self.nodes.values():
            if node.conn is conn and node.alive:
                self._on_node_disconnected(node)

    def _on_node_disconnected(self, node: NodeInfo):
        """A registered node's conn dropped.  The node's workers, plasma
        store, and local leases are (as far as we know) still running on
        the far side of a partition — so instead of the old immediate
        _mark_node_dead (actor-restart storm for what may be a seconds-long
        blip), hold the node DISCONNECTED for node_reconnect_grace_s.
        Re-registration inside the window resurrects it with actors
        intact; only expiry falls through to the death path."""
        grace = _rt_config().node_reconnect_grace_s
        node.conn = None
        node.disconnected_at = time.monotonic()
        logger.warning(
            "node %s connection lost; holding DISCONNECTED for %.1fs "
            "reconnect grace", node.node_id, grace)
        spawn(self._publish(
            "nodes", {"event": "disconnected", "node": node.public()}),
            name="gcs-publish-disconnected", log=logger)

        async def _grace_expiry():
            await asyncio.sleep(grace)
            if node.alive and node.disconnected_at is not None:
                logger.warning(
                    "node %s did not re-register within %.1fs grace; "
                    "marking dead", node.node_id, grace)
                await self._mark_node_dead(node)

        node.grace_task = asyncio.get_event_loop().create_task(_grace_expiry())

    async def _publish(self, channel: str, data: dict):
        for conn in list(self.subscribers.get(channel, [])):
            try:
                await conn.notify({"type": "pub", "channel": channel, "data": data})
            except Exception:
                pass

    # ------------------------------------------------- node stats/profile

    async def _h_report_node_stats(self, conn, msg):
        self.node_stats[msg["node_id"]] = msg["stats"]
        return None

    # Lifetime per-raylet counters that must survive node death in the
    # cluster-wide totals (see _mark_node_dead fold + util.state).
    _FOLDED_COUNTERS = ("spilled_objects", "restored_objects",
                        "objects_corrupted", "pull_retries",
                        "spill_fsync_ms", "gcs_reconnects",
                        "node_disconnects", "resync_objects_readvertised",
                        "autotune_cache_hits", "autotune_cache_misses",
                        "autotune_tune_ms",
                        "router_retries", "circuit_open",
                        "streams_resumed", "drain_handoffs",
                        "ctrl_reresolves",
                        "train_recoveries", "preemptions",
                        "ckpt_write_ms", "ckpt_restore_ms",
                        "ckpt_corrupt_skipped")

    def dead_spill_totals(self) -> Dict[str, int]:
        """Aggregate spill/restore/integrity counters folded from dead
        nodes."""
        totals = {k: 0 for k in self._FOLDED_COUNTERS}
        for entry in self._dead_spill_totals.values():
            for k in totals:
                totals[k] += entry.get(k, 0)
        return totals

    async def _h_get_node_stats(self, conn, msg):
        # "nodes" is the live per-node map; "dead_totals" carries the
        # lifetime spill/restore counters of dead nodes as an explicit
        # field (it used to ride inside the map under a synthetic
        # "__dead_nodes__" key, which every consumer had to know to
        # skip).  "invalidations" is the per-node corruption-strike map
        # (kept GCS-side: strikes are reported BY detectors AGAINST
        # holders, so no single raylet can report them).
        return {"nodes": self.node_stats,
                "dead_totals": self.dead_spill_totals(),
                "invalidations": dict(self.object_invalidations)}

    async def _h_profile_worker(self, conn, msg):
        """Route a stack-profile request to the raylet hosting ``pid``
        (reference: dashboard head -> per-node agent -> py-spy)."""
        pid = int(msg["pid"])
        # Clamp here too (the worker clamps to 30s): the RPC timeouts
        # derive from this value and must not honor a user-supplied
        # 100000s through the HTTP endpoint.
        msg = {**msg, "duration": min(float(msg.get("duration", 5.0)),
                                      30.0)}
        target = msg.get("node_id")
        if target is None:
            for nid, stats in self.node_stats.items():
                if any(w["pid"] == pid for w in stats.get("workers", [])):
                    target = nid
                    break
        req = {"type": "profile_worker", "pid": pid,
               "duration": msg.get("duration", 5.0),
               "interval": msg.get("interval", 0.01),
               "threads": msg.get("threads", "exec")}
        req_timeout = float(msg.get("duration", 5.0)) + 40.0
        if target is None:
            # The stats view is periodic and a freshly spawned worker
            # (forkserver spawns are ~20ms) may not be in it yet: ask
            # every live raylet IN PARALLEL (a wedged node must not
            # stall the one actually hosting the pid); misses answer
            # fast, first ok wins.
            async def ask(node):
                try:
                    r = await node.conn.request(req, timeout=req_timeout)
                except Exception as e:
                    r = {"ok": False, "error": repr(e)}
                # pids are only per-host unique: tag the answering node
                # so a cross-host collision is at least attributable
                r.setdefault("node_id", node.node_id.hex())
                return r

            live = [n for n in self.nodes.values() if n.alive and n.conn]
            pending = {asyncio.ensure_future(ask(n)) for n in live}
            errors = []
            try:
                while pending:
                    done, pending = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED)
                    for fut in done:
                        r = fut.result()
                        if r.get("ok"):
                            return r   # first ok wins; losers cancelled
                        errors.append(str(r.get("error")))
            finally:
                for fut in pending:
                    fut.cancel()
            return {"ok": False,
                    "error": f"no node reports a worker with pid {pid}: "
                             + "; ".join(errors)}
        for node in self.nodes.values():
            if node.node_id.hex() == target and node.alive and node.conn:
                return await node.conn.request(req, timeout=req_timeout)
        return {"ok": False, "error": f"node {target} not alive"}

    # ------------------------------------------------------------------ kv

    async def _h_kv_put(self, conn, msg):
        ns = self.kv.setdefault(msg.get("ns", ""), {})
        if not msg.get("overwrite", True) and msg["key"] in ns:
            return False
        ns[msg["key"]] = msg["value"]
        return True

    async def _h_kv_get(self, conn, msg):
        return self.kv.get(msg.get("ns", ""), {}).get(msg["key"])

    async def _h_kv_del(self, conn, msg):
        return self.kv.get(msg.get("ns", ""), {}).pop(msg["key"], None) is not None

    async def _h_kv_keys(self, conn, msg):
        prefix = msg.get("prefix", b"")
        return [k for k in self.kv.get(msg.get("ns", ""), {}) if k.startswith(prefix)]

    async def _h_kv_exists(self, conn, msg):
        return msg["key"] in self.kv.get(msg.get("ns", ""), {})

    # ------------------------------------------------------------------ nodes

    async def _h_register_node(self, conn, msg):
        node_id = NodeID.from_hex(msg["node_id"])
        existing = self.nodes.get(node_id)
        if existing is not None and existing.alive:
            return await self._resurrect_node(existing, conn, msg)
        node = NodeInfo(
            node_id=node_id,
            address=msg["address"],
            store_name=msg["store_name"],
            resources_total=dict(msg["resources"]),
            resources_available=dict(
                msg.get("resources_available", msg["resources"])),
            labels=msg.get("labels", {}),
            conn=conn,
            is_head=msg.get("is_head", False),
            pid=int(msg.get("pid", 0)),
        )
        self.nodes[node.node_id] = node
        # A node back from a transient partition resumes reporting its own
        # lifetime spill counters — keeping its folded entry would count
        # them twice in spill_totals().
        self._dead_spill_totals.pop(node.node_id.hex(), None)
        # A raylet re-registering with a freshly-restarted GCS (snapshot
        # restore forgot the node table) reports its live actors: claim
        # them BEFORE _try_schedule_pending so a snapshot-restored
        # detached actor is reconciled, not double-spawned.
        stale = await self._reconcile_node_actors(node, msg.get("actors"))
        await self._publish("nodes", {"event": "alive", "node": node.public()})
        logger.info("node registered: %s at %s", node.node_id, node.address)
        # Fire and forget, as on a heartbeat: the raylet starts its
        # heartbeats once this reply lands, and a pending actor's creation
        # (a GPU worker's cold start: torch import, CUDA init, weights)
        # can outlast the health timeout.
        spawn(self._try_schedule_pending(), name="gcs-schedule-pending",
              log=logger)
        return {"ok": True, "num_nodes": len(self.nodes),
                "stale_actors": stale}

    async def _resurrect_node(self, node: NodeInfo, conn, msg) -> dict:
        """Idempotent re-registration of a known, still-alive node_id: the
        partition healed inside the grace window (or the raylet noticed
        `{"ok": False}` heartbeats and re-registered proactively).  No
        actor-failure storm — actors the raylet still reports running keep
        their state and num_restarts; nothing is dropped from
        _dead_spill_totals because nothing was folded (the node never
        died)."""
        if node.grace_task is not None and not node.grace_task.done():
            node.grace_task.cancel()
        node.grace_task = None
        was_disconnected = node.disconnected_at is not None
        node.disconnected_at = None
        node.conn = conn
        node.address = msg["address"]
        node.store_name = msg["store_name"]
        node.resources_total = dict(msg["resources"])
        if "resources_available" in msg:
            # The raylet's availability view is authoritative (it owns the
            # leases); absent one, keep ours — resetting to totals would
            # leak the resources its still-running actors hold.
            node.resources_available = dict(msg["resources_available"])
        node.labels = msg.get("labels", node.labels)
        node.is_head = msg.get("is_head", node.is_head)
        node.pid = int(msg.get("pid", node.pid))
        node.last_heartbeat = time.monotonic()
        node.reconnects += 1
        self._dead_spill_totals.pop(node.node_id.hex(), None)
        stale = await self._reconcile_node_actors(node, msg.get("actors"))
        await self._publish("nodes", {
            "event": "reconnected" if was_disconnected else "alive",
            "node": node.public()})
        logger.info("node %s re-registered at %s (reconnect #%d)",
                    node.node_id, node.address, node.reconnects)
        spawn(self._try_schedule_pending(), name="gcs-schedule-pending",
              log=logger)
        return {"ok": True, "num_nodes": len(self.nodes),
                "reconnected": True, "stale_actors": stale}

    async def _reconcile_node_actors(self, node: NodeInfo,
                                     reported) -> List[str]:
        """Align actor records with the raylet's authoritative liveness
        list (``None`` from callers that don't report, e.g. drivers).

        Two directions: (1) actors the raylet still runs become/stay ALIVE
        here without burning a restart — in particular snapshot-restored
        detached actors sitting RESTARTING in the pending queue are
        claimed before _try_schedule_pending can spawn a duplicate;
        (2) actors this GCS maps to the node that the raylet did NOT
        report died during the partition with their death report lost —
        they go through the normal failure/restart path now.

        Returns the hex ids of reported actors this GCS will NOT honor —
        killed while the node was unreachable, or already restarted on
        another node after the grace window expired.  The raylet fences
        those incarnations (kills the local workers): the cluster just
        decided they don't exist, and leaving them running is split-brain
        (a stale direct-transport handle could keep reaching them)."""
        if reported is None:
            return []
        stale: List[str] = []
        reported_by_id = {}
        for rec in reported:
            try:
                reported_by_id[ActorID.from_hex(rec["actor_id"])] = rec
            except Exception:
                continue
        for aid, rec in reported_by_id.items():
            actor = self.actors.get(aid)
            if actor is None or actor.state == DEAD:
                stale.append(aid.hex())
                continue
            if actor.node_id is not None and actor.node_id != node.node_id:
                # The actor moved while this node was unreachable (grace
                # expired, restart landed elsewhere).  The reported copy
                # is a zombie incarnation — do NOT yank the record back.
                stale.append(aid.hex())
                logger.warning(
                    "actor %s reported by node %s but already lives on "
                    "node %s; fencing the stale incarnation",
                    aid, node.node_id, actor.node_id)
                continue
            actor.node_id = node.node_id
            if rec.get("address"):
                actor.address = rec["address"]
            if aid in self._pending_actor_queue:
                self._pending_actor_queue.remove(aid)
            if actor.state != ALIVE:
                actor.state = ALIVE
                logger.info("actor %s reconciled ALIVE on node %s (no "
                            "respawn)", aid, node.node_id)
                self._wake_waiters(actor)
                await self._publish(
                    "actors", {"event": "alive", "actor": actor.public()})
        for actor in list(self.actors.values()):
            if actor.node_id == node.node_id and actor.state == ALIVE \
                    and actor.actor_id not in reported_by_id:
                await self._on_actor_failure(
                    actor,
                    f"lost during node {node.node_id.hex()[:12]} partition")
        return stale

    async def _h_heartbeat(self, conn, msg):
        node = self.nodes.get(NodeID.from_hex(msg["node_id"]))
        if node is None:
            return {"ok": False}
        node.last_heartbeat = time.monotonic()
        if "resources_available" in msg:
            node.resources_available = msg["resources_available"]
        node.pending_demand = msg.get("pending_leases", [])
        node.reported_lag_s = float(msg.get("loop_lag_ms", 0.0)) / 1000.0
        # Retry queued actors: availability may have just been freed (a
        # worker died / finished).  Without this, an actor that queued
        # during a transient full-node view waits for a *new node
        # registration* that never comes on a static cluster.  Fire and
        # forget: blocking the heartbeat reply on actor creation would
        # stall the raylet's heartbeat loop past the health timeout.
        if self._pending_actor_queue or any(
                pg.state == "PENDING"
                for pg in self.placement_groups.values()):
            # PENDING PGs too: a PG created while the availability view
            # was transiently empty (mid task-burst heartbeat) must retry
            # when the next heartbeat shows capacity, not wait for a node
            # registration that never comes on a static cluster.
            spawn(self._try_schedule_pending(),
                  name="gcs-schedule-pending", log=logger)
        return {"ok": True}

    async def _h_get_nodes(self, conn, msg):
        return [n.public() for n in self.nodes.values()]

    async def _h_set_resource_request(self, conn, msg):
        """Programmatic autoscaler demand (reference:
        autoscaler/sdk.py request_resources -> GCS resource_request):
        replaces the whole request set; bundles are held as standing
        demand until the next call clears or changes them."""
        self._resource_request = [dict(b) for b in msg.get("bundles", [])]
        return True

    async def _h_get_load_metrics(self, conn, msg):
        """Cluster load view for the autoscaler (reference:
        autoscaler/_private/load_metrics.py fed by ray_syncer gossip)."""
        pending_tasks: List[Dict[str, float]] = []
        pending_tasks.extend(getattr(self, "_resource_request", []))
        for node in self.nodes.values():
            if node.alive:
                pending_tasks.extend(node.pending_demand)
        pending_actors = [
            self.actors[aid].resources
            for aid in self._pending_actor_queue if aid in self.actors]
        pending_pg_bundles: List[Dict[str, float]] = []
        for pg in self.placement_groups.values():
            if pg.state == "PENDING":
                for i, b in enumerate(pg.bundles):
                    if i not in pg.allocations:
                        pending_pg_bundles.append(b)
        return {
            "nodes": [n.public() for n in self.nodes.values()],
            "pending_tasks": pending_tasks,
            "pending_actors": pending_actors,
            "pending_pg_bundles": pending_pg_bundles,
        }

    async def _h_drain_node(self, conn, msg):
        node = self.nodes.get(NodeID.from_hex(msg["node_id"]))
        if node is not None:
            await self._mark_node_dead(node)
        return {"ok": True}

    async def _health_loop(self):
        while True:
            await asyncio.sleep(_heartbeat_period())
            now = time.monotonic()
            # Grace for OUR lag: if this loop stalled, heartbeats sat
            # unprocessed in socket buffers and every age below is
            # inflated by exactly that stall.
            gcs_lag = (self._watchdog.max_recent_s(_health_timeout())
                       if self._watchdog is not None else 0.0)
            cap = _rt_config().health_lag_grace_max_s
            for node in list(self.nodes.values()):
                if node.disconnected_at is not None:
                    # Conn is down, so heartbeats CANNOT arrive; the
                    # reconnect grace timer owns this node's verdict.
                    continue
                # Grace for THEIR lag: a raylet that recently reported a
                # big stall (spawn storm, /proc scan) earns its lag back.
                # Both terms are capped — grace forgives transient lag,
                # never an actually-silent node.
                grace = min(cap, gcs_lag + node.reported_lag_s)
                if node.alive and not node.is_head and \
                        now - node.last_heartbeat > _health_timeout() + grace:
                    logger.warning(
                        "node %s missed heartbeats for %.1fs (timeout "
                        "%.1fs + lag grace %.1fs); marking dead",
                        node.node_id, now - node.last_heartbeat,
                        _health_timeout(), grace)
                    await self._mark_node_dead(node)

    async def _mark_node_dead(self, node: NodeInfo):
        if not node.alive:
            return
        node.alive = False
        # Cancel any pending resurrection grace (unless we ARE the grace
        # expiry task — cancelling ourselves would abort this death
        # half-done at the next await).
        if node.grace_task is not None and not node.grace_task.done() \
                and node.grace_task is not asyncio.current_task():
            node.grace_task.cancel()
        node.grace_task = None
        node.disconnected_at = None
        # Drop its stats report: dead-node workers must neither linger in
        # the dashboard nor shadow reused pids in profile routing — but
        # fold its spill counters into the lifetime carry-over first.
        dropped = self.node_stats.pop(node.node_id.hex(), None)
        if dropped:
            # Overwrite (not +=): the counters are lifetime totals, so a
            # node that died before with the same id replaces its entry.
            self._dead_spill_totals[node.node_id.hex()] = {
                k: dropped.get(k, 0) for k in self._FOLDED_COUNTERS}
        await self._publish("nodes", {"event": "dead", "node": node.public()})
        # Restart or kill actors that lived on this node.
        for actor in list(self.actors.values()):
            if actor.node_id == node.node_id and actor.state in (ALIVE, PENDING, RESTARTING):
                await self._on_actor_failure(actor, f"node {node.node_id.hex()} died")
        # Drop object locations on that node (its spill files die with it).
        nh = node.node_id.hex()
        for oid, entry in list(self.object_dir.items()):
            entry.nodes.discard(nh)
            entry.spilled.pop(nh, None)

    # ------------------------------------------------------------------ jobs

    async def _h_register_job(self, conn, msg):
        self.jobs[msg["job_id"]] = {
            "job_id": msg["job_id"], "driver_address": msg.get("driver_address"),
            "start_time": time.time(), "state": "RUNNING",
        }
        return {"ok": True}

    async def _h_finish_job(self, conn, msg):
        job = self.jobs.get(msg["job_id"])
        if job:
            job["state"] = "FINISHED"
            job["end_time"] = time.time()
        return {"ok": True}

    async def _h_get_jobs(self, conn, msg):
        return list(self.jobs.values())

    # ------------------------------------------------------------------ actors

    async def _h_create_actor(self, conn, msg):
        actor_id = ActorID.from_hex(msg["actor_id"])
        name = msg.get("name")
        namespace = msg.get("namespace", "default")
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing is not None and existing.state != DEAD:
                    if msg.get("get_if_exists"):
                        return {"ok": True, "existing": True,
                                "actor_id": existing.actor_id.hex()}
                    raise ValueError(f"actor name '{name}' already taken")
            self.named_actors[key] = actor_id
        actor = ActorInfo(
            actor_id=actor_id,
            name=name,
            namespace=namespace,
            state=PENDING,
            creation_spec=msg["creation_spec"],
            resources=msg.get("resources", {"CPU": 1}),
            max_restarts=msg.get("max_restarts", 0),
            owner_job=msg.get("job_id"),
            detached=msg.get("detached", False),
            scheduling=msg.get("scheduling", {}),
            method_meta=msg.get("method_meta") or {},
        )
        self.actors[actor_id] = actor
        logger.debug("create_actor %s: scheduling", actor_id)
        spawn(self._schedule_actor(actor), name="gcs-schedule-actor",
              log=logger)
        return {"ok": True, "existing": False, "actor_id": actor_id.hex()}

    def _pick_node_for(self, resources: Dict[str, float],
                       scheduling: dict) -> Optional[NodeInfo]:
        """Hybrid policy over the GCS resource view (reference:
        gcs_actor_scheduler.h + hybrid_scheduling_policy.h): feasible nodes,
        prefer the one with most available of the dominant resource."""
        pg_hex = scheduling.get("placement_group_id")
        if pg_hex:
            pg = self.placement_groups.get(PlacementGroupID.from_hex(pg_hex))
            if pg and pg.state == "CREATED":
                idx = scheduling.get("bundle_index", 0)
                if idx == -1:
                    idx = 0
                nid = pg.allocations.get(idx)
                node = self.nodes.get(nid) if nid else None
                if node and node.schedulable:
                    return node
            return None
        node_hex = scheduling.get("node_id")
        if node_hex:
            node = self.nodes.get(NodeID.from_hex(node_hex))
            if node and node.schedulable and self._fits(node, resources):
                return node
            if not scheduling.get("soft", False):
                return None
        # DISCONNECTED nodes (alive, conn down) are not schedulable: a
        # create/lease RPC has nowhere to go until the partition heals.
        candidates = [n for n in self.nodes.values()
                      if n.schedulable and self._fits(n, resources)]
        if not candidates:
            return None
        if scheduling.get("strategy") == "SPREAD":
            candidates.sort(key=lambda n: -sum(n.resources_available.values()))
            return candidates[0]
        dominant = max(resources, key=resources.get) if resources else "CPU"
        candidates.sort(key=lambda n: -n.resources_available.get(dominant, 0.0))
        return candidates[0]

    @staticmethod
    def _fits(node: NodeInfo, resources: Dict[str, float]) -> bool:
        return all(node.resources_available.get(k, 0.0) >= v
                   for k, v in resources.items() if v > 0)

    async def _schedule_actor(self, actor: ActorInfo):
        node = self._pick_node_for(actor.resources, actor.scheduling)
        if node is None:
            # No feasible node right now; retried on node registration and
            # on every heartbeat (resource view refresh).
            if actor.actor_id not in self._pending_actor_queue:
                logger.info("actor %s queued (no feasible node; need %s)",
                            actor.actor_id, actor.resources)
                self._pending_actor_queue.append(actor.actor_id)
            return
        actor.node_id = node.node_id
        for k, v in actor.resources.items():
            node.resources_available[k] = node.resources_available.get(k, 0.0) - v
        try:
            reply = await node.conn.request({
                "type": "create_actor_worker",
                "actor_id": actor.actor_id.hex(),
                "job_id": actor.owner_job,
                "creation_spec": actor.creation_spec,
                "resources": actor.resources,
                "pg_id": actor.scheduling.get("placement_group_id"),
                "bundle_index": actor.scheduling.get("bundle_index", 0) or 0,
                "runtime_env": actor.scheduling.get("runtime_env"),
            }, timeout=240)
            actor.address = reply["address"]
            actor.state = ALIVE
            actor.creation_attempts = 0  # fresh retry budget per (re)start
            logger.debug("actor %s alive at %s", actor.actor_id,
                         actor.address)
            self._wake_waiters(actor)
            await self._publish("actors", {"event": "alive", "actor": actor.public()})
        except Exception as e:
            logger.warning("actor %s creation on node %s failed: %s",
                           actor.actor_id, node.node_id, e)
            # Spawn flakiness (worker stuck in startup, transient node load)
            # is retried with a fresh process before burning a user-visible
            # restart (reference: GcsActorScheduler reschedules on failure).
            for k, v in actor.resources.items():
                node.resources_available[k] = \
                    node.resources_available.get(k, 0.0) + v
            actor.node_id = None
            actor.address = None
            if actor.creation_attempts < _rt_config().actor_creation_attempts:
                actor.creation_attempts += 1
                logger.info("actor %s: creation retry %d", actor.actor_id,
                            actor.creation_attempts)
                await self._schedule_actor(actor)
            else:
                await self._on_actor_failure(actor, f"creation failed: {e}")

    async def _try_schedule_pending(self):
        queue, self._pending_actor_queue = self._pending_actor_queue, []
        for actor_id in queue:
            actor = self.actors.get(actor_id)
            if actor is not None and actor.state in (PENDING, RESTARTING):
                await self._schedule_actor(actor)
        # PGs restored from a snapshot (or whose placement failed earlier)
        # retry whenever capacity appears.
        for pg in list(self.placement_groups.values()):
            if pg.state == "PENDING":
                await self._schedule_pg(pg)

    async def _on_actor_failure(self, actor: ActorInfo, reason: str):
        # Restart counts / DEAD transitions from the health loop mutate
        # durable state outside any RPC handler.
        self._dirty = True
        node = self.nodes.get(actor.node_id) if actor.node_id else None
        if node is not None and node.alive:
            for k, v in actor.resources.items():
                node.resources_available[k] = node.resources_available.get(k, 0.0) + v
        actor.address = None
        actor.node_id = None
        if actor.max_restarts == -1 or actor.num_restarts < actor.max_restarts:
            actor.num_restarts += 1
            actor.state = RESTARTING
            await self._publish("actors", {"event": "restarting",
                                           "actor": actor.public()})
            await self._schedule_actor(actor)
        else:
            actor.state = DEAD
            actor.death_cause = reason
            self._wake_waiters(actor)
            await self._publish("actors", {"event": "dead", "actor": actor.public()})

    def _wake_waiters(self, actor: ActorInfo):
        for fut in actor.waiters:
            if not fut.done():
                fut.set_result(actor.public())
        actor.waiters.clear()

    async def _h_report_actor_death(self, conn, msg):
        actor = self.actors.get(ActorID.from_hex(msg["actor_id"]))
        if actor is None or actor.state == DEAD:
            return {"ok": True}
        if msg.get("address") is not None and \
                msg["address"] != actor.address:
            # A raylet's report of an incarnation that is already gone
            # from the record: ``kill(no_restart=False)`` restarted the
            # actor when it asked for the kill, before the raylet reaped
            # the old process.  Acting on it would restart the actor a
            # second time and orphan the live first restart.
            return {"ok": True}
        if msg.get("intended", False):
            actor.state = DEAD
            actor.death_cause = "killed intentionally"
            node = self.nodes.get(actor.node_id) if actor.node_id else None
            if node is not None:
                for k, v in actor.resources.items():
                    node.resources_available[k] = \
                        node.resources_available.get(k, 0.0) + v
            self._wake_waiters(actor)
            await self._publish("actors", {"event": "dead", "actor": actor.public()})
        else:
            await self._on_actor_failure(actor, msg.get("reason", "worker died"))
        return {"ok": True}

    async def _h_get_actor_info(self, conn, msg):
        actor = self.actors.get(ActorID.from_hex(msg["actor_id"]))
        return actor.public() if actor else None

    async def _h_wait_actor_state(self, conn, msg):
        """Long-poll until the actor reaches ALIVE or DEAD (addr resolution)."""
        actor = self.actors.get(ActorID.from_hex(msg["actor_id"]))
        if actor is None:
            return None
        if actor.state in (ALIVE, DEAD):
            return actor.public()
        fut = asyncio.get_running_loop().create_future()
        actor.waiters.append(fut)
        return await fut

    async def _h_get_named_actor(self, conn, msg):
        key = (msg.get("namespace", "default"), msg["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None:
            return None
        actor = self.actors.get(actor_id)
        return actor.public() if actor and actor.state != DEAD else None

    async def _h_list_actors(self, conn, msg):
        return [a.public() for a in self.actors.values()]

    async def _h_list_named_actors(self, conn, msg):
        out = []
        for (ns, name), aid in self.named_actors.items():
            a = self.actors.get(aid)
            if a is not None and a.state != DEAD:
                out.append({"namespace": ns, "name": name})
        return out

    async def _h_kill_actor(self, conn, msg):
        actor = self.actors.get(ActorID.from_hex(msg["actor_id"]))
        if actor is None:
            return {"ok": False}
        node = self.nodes.get(actor.node_id) if actor.node_id else None
        if node is not None and node.conn is not None:
            try:
                await node.conn.request({"type": "kill_actor_worker",
                                         "actor_id": actor.actor_id.hex(),
                                         "no_restart": msg.get("no_restart", True)})
            except Exception:
                pass
        if msg.get("no_restart", True):
            actor.max_restarts = actor.num_restarts  # exhaust restarts
        await self._h_report_actor_death(conn, {
            "actor_id": actor.actor_id.hex(),
            "intended": msg.get("no_restart", True),
            "reason": "ray.kill",
        })
        return {"ok": True}

    # ------------------------------------------------------------- placement

    async def _h_create_placement_group(self, conn, msg):
        pg = PlacementGroupInfo(
            pg_id=PlacementGroupID.from_hex(msg["pg_id"]),
            bundles=msg["bundles"],
            strategy=msg.get("strategy", "PACK"),
        )
        self.placement_groups[pg.pg_id] = pg
        spawn(self._schedule_pg(pg), name="gcs-schedule-pg", log=logger)
        return {"ok": True}

    async def _schedule_pg(self, pg: PlacementGroupInfo):
        """Bundle packing (reference: gcs_placement_group_scheduler.h +
        bundle_scheduling_policy.h).  PACK fills one node first; SPREAD
        round-robins; STRICT_PACK requires a single node; STRICT_SPREAD
        requires distinct nodes."""
        if pg.scheduling_in_progress or pg.state != "PENDING":
            return
        pg.scheduling_in_progress = True
        try:
            await self._schedule_pg_inner(pg)
        finally:
            pg.scheduling_in_progress = False

    @staticmethod
    def _slice_of(resources: Dict[str, float]) -> Optional[str]:
        for k in resources:
            if k.startswith("tpu-slice:"):
                return k
        return None

    def _pg_node_order(self, pg: PlacementGroupInfo,
                       avail: Dict[NodeID, Dict[str, float]]) -> List[NodeID]:
        """Candidate order for bundle packing.  TPU bundles get ICI-aware
        ordering: hosts of the same slice are contiguous, slices ranked by
        free TPU, so PACK fills one slice (ICI-connected) before touching
        another — collectives ride ICI, not DCN (SURVEY hard part (b);
        reference has no TPU notion, its BundleSchedulingPolicy is flat)."""
        wants_tpu = any(b.get("TPU", 0) > 0 for b in pg.bundles)
        if not wants_tpu:
            return sorted(avail, key=lambda nid: -sum(avail[nid].values()))
        slice_free: Dict[Optional[str], float] = {}
        for nid, res in avail.items():
            s = self._slice_of(res)
            slice_free[s] = slice_free.get(s, 0.0) + res.get("TPU", 0.0)
        return sorted(
            avail,
            key=lambda nid: (
                # Slices with the most free TPU first; sliceless hosts last.
                -(slice_free.get(self._slice_of(avail[nid]), 0.0)),
                self._slice_of(avail[nid]) or "~",   # group slice hosts
                -avail[nid].get("TPU", 0.0),
                -sum(avail[nid].values())))

    async def _schedule_pg_inner(self, pg: PlacementGroupInfo):
        avail = {n.node_id: dict(n.resources_available)
                 for n in self.nodes.values() if n.schedulable}
        order = self._pg_node_order(pg, avail)
        placement: Dict[int, NodeID] = {}

        def fits(nid, bundle):
            return all(avail[nid].get(k, 0.0) >= v for k, v in bundle.items())

        def take(nid, bundle):
            for k, v in bundle.items():
                avail[nid][k] = avail[nid].get(k, 0.0) - v

        ok = True
        if pg.strategy in ("PACK", "STRICT_PACK"):
            for i, bundle in enumerate(pg.bundles):
                chosen = None
                for nid in order:
                    if fits(nid, bundle) and (
                        pg.strategy != "STRICT_PACK" or not placement
                        or nid == next(iter(placement.values()))
                    ):
                        chosen = nid
                        break
                if chosen is None:
                    ok = False
                    break
                placement[i] = chosen
                take(chosen, bundle)
        else:  # SPREAD / STRICT_SPREAD
            used: Set[NodeID] = set()
            rank_of = {nid: i for i, nid in enumerate(order)}
            for i, bundle in enumerate(pg.bundles):
                # Prefer unused nodes, but keep _pg_node_order's ranking
                # (ICI slice grouping for TPU bundles) as the tiebreaker —
                # re-sorting by raw free-resource sums would scatter TPU
                # bundles across slices.
                ranked = sorted(order, key=lambda nid: (nid in used,
                                                        rank_of[nid]))
                chosen = None
                for nid in ranked:
                    if pg.strategy == "STRICT_SPREAD" and nid in used:
                        continue
                    if fits(nid, bundle):
                        chosen = nid
                        break
                if chosen is None:
                    ok = False
                    break
                placement[i] = chosen
                used.add(chosen)
                take(chosen, bundle)

        if not ok:
            # Leave PENDING; retried when nodes register.
            return
        # Reserve on each node daemon (single-phase commit with rollback;
        # the reference does 2PC prepare/commit -- node_manager.proto:378).
        reserved: List[Tuple[NodeInfo, int]] = []
        try:
            for i, nid in placement.items():
                node = self.nodes[nid]
                await node.conn.request({
                    "type": "reserve_bundle",
                    "pg_id": pg.pg_id.hex(),
                    "bundle_index": i,
                    "bundle": pg.bundles[i],
                })
                reserved.append((node, i))
                for k, v in pg.bundles[i].items():
                    node.resources_available[k] = \
                        node.resources_available.get(k, 0.0) - v
            pg.allocations = {i: nid for i, nid in placement.items()}
            pg.state = "CREATED"
            for fut in pg.waiters:
                if not fut.done():
                    fut.set_result(pg.public())
            pg.waiters.clear()
            await self._try_schedule_pending()
        except Exception as e:
            logger.warning("pg %s reservation failed: %s", pg.pg_id, e)
            for node, i in reserved:
                try:
                    await node.conn.request({"type": "return_bundle",
                                             "pg_id": pg.pg_id.hex(),
                                             "bundle_index": i,
                                             "bundle": pg.bundles[i]})
                except Exception:
                    pass

    async def _h_pg_wait_ready(self, conn, msg):
        pg = self.placement_groups.get(PlacementGroupID.from_hex(msg["pg_id"]))
        if pg is None:
            return None
        if pg.state == "CREATED":
            return pg.public()
        fut = asyncio.get_running_loop().create_future()
        pg.waiters.append(fut)
        timeout = msg.get("timeout")
        if timeout:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def _h_remove_placement_group(self, conn, msg):
        pg = self.placement_groups.get(PlacementGroupID.from_hex(msg["pg_id"]))
        if pg is None:
            return {"ok": False}
        for i, nid in pg.allocations.items():
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                continue
            try:
                await node.conn.request({"type": "return_bundle",
                                         "pg_id": pg.pg_id.hex(),
                                         "bundle_index": i,
                                         "bundle": pg.bundles[i]})
            except Exception:
                pass
            for k, v in pg.bundles[i].items():
                node.resources_available[k] = node.resources_available.get(k, 0.0) + v
        pg.state = "REMOVED"
        return {"ok": True}

    async def _h_get_placement_group(self, conn, msg):
        pg = self.placement_groups.get(PlacementGroupID.from_hex(msg["pg_id"]))
        return pg.public() if pg else None

    # ------------------------------------------------------------- objects

    async def _h_object_location_add(self, conn, msg):
        oid = msg["object_id"]
        owner = msg.get("owner", "")
        entry = self.object_dir.get(oid)
        if entry is None:
            self.object_dir[oid] = ObjectDirEntry(
                owner, {msg["node_id"]}, size=int(msg.get("size", 0)),
                checksum=msg.get("checksum"))
        else:
            entry.nodes.add(msg["node_id"])
            entry.spilled.pop(msg["node_id"], None)  # restored
            if msg.get("size"):
                entry.size = int(msg["size"])
            if msg.get("checksum") is not None:
                # The creator's stamp is authoritative; later adds are
                # pullers registering a verified copy (same bytes), and a
                # reconstruction re-stamps through the same path.
                entry.checksum = msg["checksum"]
        return {"ok": True}

    async def _h_object_locations_get_many(self, conn, msg):
        """Batch location lookup (locality-aware lease policy: one RPC per
        task submission, not one per argument)."""
        out = {}
        for oid in msg["object_ids"]:
            entry = self.object_dir.get(oid)
            if entry is not None:
                out[oid] = {"nodes": list(entry.nodes),
                            "spilled": dict(entry.spilled),
                            "size": entry.size,
                            "checksum": entry.checksum}
        return out

    async def _h_object_locations_get(self, conn, msg):
        entry = self.object_dir.get(msg["object_id"])
        if entry is None:
            return None
        return {"owner": entry.owner, "nodes": list(entry.nodes),
                "spilled": dict(entry.spilled),
                "checksum": entry.checksum}

    async def _h_object_location_remove(self, conn, msg):
        entry = self.object_dir.get(msg["object_id"])
        if entry is not None:
            entry.nodes.discard(msg["node_id"])
            if not entry.nodes and not entry.spilled:
                del self.object_dir[msg["object_id"]]
        return {"ok": True}

    async def _h_object_location_invalidate(self, conn, msg):
        """A puller/restorer detected checksum-mismatched bytes served by
        ``node_id``: quarantine that copy — drop it from the directory so
        no other puller is routed to it — and count the strike against the
        node (`/api/metrics` ray_tpu_object_location_invalidations).  The
        copy itself is left to its holder; with the location gone it is
        unreachable, and deleting it remotely would destroy a possibly
        healthy copy when the corruption happened in transit."""
        oid = msg["object_id"]
        nh = msg["node_id"]
        self.object_invalidations[nh] = \
            self.object_invalidations.get(nh, 0) + 1
        entry = self.object_dir.get(oid)
        removed = False
        if entry is not None:
            if nh in entry.nodes:
                entry.nodes.discard(nh)
                removed = True
            if entry.spilled.pop(nh, None) is not None:
                removed = True
            if not entry.nodes and not entry.spilled:
                del self.object_dir[oid]
        logger.warning(
            "object %s copy on node %s invalidated (%s); %d strikes "
            "against that node", oid[:16], nh[:12],
            msg.get("reason", "checksum mismatch"),
            self.object_invalidations[nh])
        return {"ok": True, "removed": removed}

    async def _h_object_spilled(self, conn, msg):
        """A node moved its in-memory copy to disk (reference:
        LocalObjectManager::SpillObjects reporting spilled URLs).  An
        unknown object means the owner freed it while the spill was in
        flight — refuse, so the raylet deletes the orphan file instead of
        resurrecting a freed entry."""
        entry = self.object_dir.get(msg["object_id"])
        if entry is None:
            return {"ok": False}
        entry.spilled[msg["node_id"]] = msg["path"]
        entry.nodes.discard(msg["node_id"])
        return {"ok": True}

    async def _h_resync_locations(self, conn, msg):
        """Post-partition location resync: one batched re-advertisement of
        every sealed in-memory copy and spill file a reconnecting raylet
        holds, so the directory heals from any drops performed while the
        node was unreachable (a >grace death dropped them all; a GCS
        restart lost the whole directory).  Unlike _h_object_spilled,
        an unknown spilled oid here must NOT be refused — refusal makes
        the raylet delete the file, and after a directory loss every
        entry is unknown.  Creates entries with owner "" (the owner
        re-stamps on its next location_add), which is exactly what
        _h_object_location_add does for unknown oids."""
        nh = msg["node_id"]
        added = 0
        for oid in msg.get("objects", []):
            entry = self.object_dir.get(oid)
            if entry is None:
                self.object_dir[oid] = ObjectDirEntry("", {nh})
            else:
                entry.nodes.add(nh)
                entry.spilled.pop(nh, None)
            added += 1
        for oid, path in msg.get("spilled", {}).items():
            entry = self.object_dir.get(oid)
            if entry is None:
                entry = self.object_dir[oid] = ObjectDirEntry("")
            entry.spilled[nh] = path
            added += 1
        if added:
            logger.info("node %s resynced %d object locations", nh[:12],
                        added)
        return {"ok": True, "count": added}

    async def _h_objects_on_node(self, conn, msg):
        """Plasma-resident object ids on a node (spill candidate listing)."""
        node = msg["node_id"]
        return [oid for oid, e in self.object_dir.items()
                if node in e.nodes]

    async def _h_object_freed(self, conn, msg):
        """Owner dropped its last reference: delete every copy cluster-wide,
        including spill files (reference: ReferenceCounter eager deletion
        fanning out through the object directory)."""
        entry = self.object_dir.pop(msg["object_id"], None)
        if entry is None:
            return {"ok": True}
        by_hex = {n.node_id.hex(): n for n in self.nodes.values()}
        for nh in entry.nodes:
            node = by_hex.get(nh)
            if node is not None and node.alive and node.conn is not None:
                try:
                    await node.conn.notify({
                        "type": "delete_object",
                        "object_id": msg["object_id"]})
                except Exception:
                    pass
        for nh, path in entry.spilled.items():
            node = by_hex.get(nh)
            if node is not None and node.alive and node.conn is not None:
                try:
                    await node.conn.notify({
                        "type": "delete_spilled",
                        "object_id": msg["object_id"], "path": path})
                except Exception:
                    pass
        return {"ok": True}

    # ------------------------------------------------------------- pubsub

    async def _h_subscribe(self, conn, msg):
        subs = self.subscribers.setdefault(msg["channel"], [])
        if conn not in subs:
            subs.append(conn)
        return {"ok": True}

    async def _h_unsubscribe(self, conn, msg):
        subs = self.subscribers.get(msg["channel"], [])
        if conn in subs:
            subs.remove(conn)
        return {"ok": True}

    async def _h_publish(self, conn, msg):
        """Generic publish relay: raylets push worker-log batches (and any
        future producer-defined channel) through the GCS fan-out
        (reference pubsub/publisher.h GcsPublisher)."""
        await self._publish(msg["channel"], msg["data"])
        return {"ok": True}

    # ------------------------------------------------- observability

    async def _h_task_events(self, conn, msg):
        """Batched per-task profile events from executors (reference:
        TaskEventBuffer -> GcsTaskManager, gcs_task_manager.h:40)."""
        self.task_events.extend(msg["events"])
        return {"ok": True}

    async def _h_list_task_events(self, conn, msg):
        """Filter push-down + pagination (reference state-API server-side
        filtering): name/status/kind predicates apply BEFORE the limit
        window, and (offset, limit) page newest-first so a driver never
        ships the whole retention window to render one page."""
        limit = msg.get("limit", 10000)
        offset = msg.get("offset", 0)
        name = msg.get("name")
        status = msg.get("status")
        kind = msg.get("kind")
        trace_id = msg.get("trace_id")
        evs = self.task_events
        sel = [e for e in evs
               if (name is None or e.get("name") == name)
               and (status is None or e.get("status") == status)
               and (kind is None or e.get("kind") == kind)
               and (trace_id is None or e.get("trace_id") == trace_id)]
        total = len(sel)
        # newest-first pagination: offset 0 = most recent `limit` events
        if offset or limit < total:
            end = total - offset
            sel = sel[max(0, end - limit):max(0, end)]
        if msg.get("with_total"):
            return {"events": sel, "total": total}
        return sel

    async def _h_list_objects(self, conn, msg):
        return [{"object_id": oid, "owner": e.owner,
                 "locations": sorted(e.nodes),
                 "spilled": dict(e.spilled)}
                for oid, e in self.object_dir.items()]

    async def _h_list_placement_groups(self, conn, msg):
        return [{"pg_id": pg.pg_id.hex(), "bundles": pg.bundles,
                 "strategy": pg.strategy,
                 "allocations": {str(k): v.hex() if hasattr(v, "hex") else v
                                 for k, v in
                                 (pg.allocations or {}).items()}}
                for pg in self.placement_groups.values()]

    async def _h_report_metrics(self, conn, msg):
        """Per-process metric snapshots (reference: OpenCensus exporter ->
        metrics agent; util/metrics.py user API).  Stored per
        (name, labels, pid), stamped with report time, and capped."""
        now = time.time()
        for m in msg["metrics"]:
            key = (m["name"], tuple(sorted(m.get("labels", {}).items())),
                   msg.get("pid", 0))
            m["_ts"] = now
            self.metrics[key] = m
        if len(self.metrics) > 10000:
            # Prune the stalest per-process series (dead-pid leftovers).
            for key in sorted(self.metrics,
                              key=lambda k: self.metrics[k]["_ts"])[:1000]:
                del self.metrics[key]
        return {"ok": True}

    async def _h_list_metrics(self, conn, msg):
        return self.aggregated_metrics()

    def aggregated_metrics(self) -> List[dict]:
        """Cluster-wide metric aggregation by (name, labels): counters sum,
        gauges last-write-wins by report time, histogram buckets merge.
        Shared by the list_metrics RPC and the dashboard exposition."""
        agg: Dict[tuple, dict] = {}
        for (name, labels, _pid), m in self.metrics.items():
            k = (name, labels)
            cur = agg.get(k)
            if cur is None:
                agg[k] = {"name": name, "labels": dict(labels),
                          "type": m["type"], "value": m["value"],
                          "buckets": dict(m.get("buckets") or {}),
                          "_ts": m.get("_ts", 0)}
            elif m["type"] == "counter":
                agg[k]["value"] += m["value"]
            elif m["type"] == "gauge":
                # Last write wins across processes BY REPORT TIME (dict
                # order would let a stale, even dead-process value win).
                if m.get("_ts", 0) >= agg[k]["_ts"]:
                    agg[k]["value"] = m["value"]
                    agg[k]["_ts"] = m.get("_ts", 0)
            elif m["type"] == "histogram":
                agg[k]["value"] += m["value"]
                for b, c in (m.get("buckets") or {}).items():
                    agg[k]["buckets"][b] = agg[k]["buckets"].get(b, 0) + c
        out = list(agg.values())
        for m in out:
            m.pop("_ts", None)
        return out

    # ------------------------------------------------------------- misc

    async def _h_cluster_resources(self, conn, msg):
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.resources_total.items():
                total[k] = total.get(k, 0.0) + v
            for k, v in n.resources_available.items():
                avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}

    async def _h_ping(self, conn, msg):
        return {"ok": True, "time": time.time()}
