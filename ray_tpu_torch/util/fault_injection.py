"""Deterministic fault injection for chaos testing.

Reference analog: ``python/ray/_private/test_utils.py`` NodeKillerActor
(:1346) — the reference treats failure injection as a first-class,
reusable API so chaos tests gate their assertions on *observed* cluster
state (death recorded, recovery complete) instead of ad-hoc process
kills plus wall-clock sleeps.  Two halves:

* **Process-local hooks.**  A JSON spec in the ``RT_FAULT_INJECTION``
  env var, parsed once per process.  Daemons consult it at exactly three
  injection points: the forkserver template serve loop (``"forkserver":
  "wedge"`` accepts connections and never replies; ``{"mode": "slow",
  "delay_s": X}`` replies late), the raylet heartbeat loop
  (``"heartbeat_delay_s": X`` stretches the period), and the RPC frame
  send path (``"drop_rpc": {"conn": <name substring>, "every": N}``
  silently drops every Nth outgoing frame on matching connections —
  see ``protocol.set_frame_fault``).  Start ONE node of a test cluster
  with ``env=env_for(...)`` to fault just that node.

* **NodeKiller.**  Kills node daemons by the pid each raylet registers
  with the GCS, then waits for the GCS to record the death.  Usable
  directly in a driver or as an actor via
  ``ray_tpu_torch.remote(NodeKiller)``.

The serve hooks (slow clients, stalled streams and decodes,
``kill_replica``) drive the serving fleet's chaos cases; the train hooks
(preemption notices, slow checkpoint writes, ``kill_train_worker``) drive
the train gang's.

Everything here is import-light (stdlib only at module load) because the
forkserver template and the protocol layer import it inside daemons.
"""

from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

ENV_VAR = "RT_FAULT_INJECTION"


@dataclass
class FaultSpec:
    forkserver: Optional[Any] = None     # "wedge" | {"mode","delay_s"}
    heartbeat_delay_s: float = 0.0
    drop_rpc: Optional[Dict[str, Any]] = None
    # Data-plane faults (see raylet fetch/spill paths):
    # corrupt_chunk: {"every": N} — bit-flip every Nth fetch chunk SERVED
    # by this process (models bad RAM/NIC on a holder node).
    corrupt_chunk: Optional[Any] = None
    # truncate_spill: {"every": N, "keep": fraction} — truncate every Nth
    # spill file right after its durable write (models a torn write that
    # survived a crash, the exact artifact the spill header detects).
    truncate_spill: Optional[Any] = None
    # drop_fetch_reply: {"every": N} — fail every Nth fetch_object request
    # with an error reply (models a flaky holder; the puller's retry
    # rounds, not lineage, should absorb it).
    drop_fetch_reply: Optional[Any] = None
    # Serve streaming faults (see serve/http_ingress.py and the Replica
    # stream path):
    # slow_client: {"delay_s": X} — stretch every ingress socket drain by
    # X seconds (models a client reading slower than tokens are
    # produced; drives the per-connection write timeout).
    slow_client: Optional[Any] = None
    # stall_stream: {"after": N, "stall_s": X} — the Nth streamed item
    # this process yields is delayed X seconds (models a wedged decode
    # step; drives the ingress stream-idle timeout).
    stall_stream: Optional[Any] = None
    # stall_replica_decode: {"after": N, "stall_s": X} — the Nth batched
    # decode step this process's inference engine dispatches is delayed X
    # seconds (models a wedged device/dispatch: the replica actor stays
    # ALIVE but produces no tokens; drives the ingress stall detector
    # RT_SERVE_STALL_S into a mid-stream failover).
    stall_replica_decode: Optional[Any] = None
    # partition: {"conn": substr, "after_s": N, "heal_s": M?} — a
    # control-plane partition window: ``after_s`` seconds into the
    # process's life, force-close (and refuse to redial) every connection
    # whose name contains ``conn``; the window heals ``heal_s`` seconds
    # later (omit heal_s for a permanent partition).  Exercises the
    # reconnect/resurrection machinery end to end (protocol redial, GCS
    # grace timer, raylet resync).
    partition: Optional[Dict[str, Any]] = None
    # Training faults (see train/_internal/worker_group.py session and
    # train/_internal/checkpoint_store.py):
    # preempt_notice: {"after_s": X, "grace_s": Y, "rank": R?} — X
    # seconds into the worker process's train loop, deliver a preemption
    # notice with a Y-second grace deadline (optionally only to world
    # rank R).  The worker finishes its in-flight microbatch, writes a
    # final checkpoint at the next step boundary, and exits CLEAN — the
    # gang supervisor records a planned handoff (``preemptions``), not a
    # failure, and restarts without burning recovery budget.
    preempt_notice: Optional[Dict[str, Any]] = None
    # slow_ckpt_io: {"delay_s": X} — stretch every checkpoint shard
    # write by X seconds (models slow/remote checkpoint storage; drives
    # the async writer's one-in-flight backpressure so overlap tests are
    # deterministic instead of racing fast local disk).
    slow_ckpt_io: Optional[Any] = None

    @classmethod
    def from_env(cls) -> "FaultSpec":
        blob = os.environ.get(ENV_VAR)
        if not blob:
            return cls()
        try:
            raw = json.loads(blob)
        except (json.JSONDecodeError, TypeError):
            return cls()
        return cls(
            forkserver=raw.get("forkserver"),
            heartbeat_delay_s=float(raw.get("heartbeat_delay_s", 0.0)),
            drop_rpc=raw.get("drop_rpc"),
            corrupt_chunk=raw.get("corrupt_chunk"),
            truncate_spill=raw.get("truncate_spill"),
            drop_fetch_reply=raw.get("drop_fetch_reply"),
            slow_client=raw.get("slow_client"),
            stall_stream=raw.get("stall_stream"),
            stall_replica_decode=raw.get("stall_replica_decode"),
            partition=raw.get("partition"),
            preempt_notice=raw.get("preempt_notice"),
            slow_ckpt_io=raw.get("slow_ckpt_io"),
        )


_spec_cache: Optional[FaultSpec] = None

# Per-process every-Nth counters for the data-plane faults (deterministic,
# like make_drop_filter's per-connection counts).
_counters: Dict[str, int] = {}


def _every_nth(name: str, fault: Any) -> bool:
    """True on the Nth, 2Nth, ... consultation of ``name`` while ``fault``
    is active.  Accepts {"every": N}, a bare int N, or true (N=1)."""
    if not fault:
        return False
    if isinstance(fault, dict):
        every = int(fault.get("every", 1))
    elif isinstance(fault, bool):
        every = 1
    else:
        every = int(fault)
    n = _counters.get(name, 0) + 1
    _counters[name] = n
    return every > 0 and n % every == 0


def spec() -> FaultSpec:
    """The process's active fault spec (cached env parse)."""
    global _spec_cache
    if _spec_cache is None:
        _spec_cache = FaultSpec.from_env()
    return _spec_cache


def set_spec(**kwargs) -> FaultSpec:
    """In-process override for unit tests (does not touch the env, so
    subprocesses are unaffected).  Pair with clear_spec()."""
    global _spec_cache, _partition_anchor, _preempt_anchor
    _spec_cache = FaultSpec(**kwargs)
    _counters.clear()
    _partition_anchor = None
    _preempt_anchor = None
    return _spec_cache


def clear_spec() -> None:
    global _spec_cache, _partition_anchor, _preempt_anchor
    _spec_cache = None
    _counters.clear()
    _partition_anchor = None
    _preempt_anchor = None


def env_for(**kwargs) -> Dict[str, str]:
    """Env fragment that activates the given faults in a subprocess:
    ``Cluster.add_node(env=fault_injection.env_for(forkserver="wedge"))``."""
    return {ENV_VAR: json.dumps(kwargs)}


def forkserver_fault() -> Tuple[str, float]:
    """(mode, delay_s) for the forkserver template serve loop."""
    fs = spec().forkserver
    if not fs:
        return "", 0.0
    if isinstance(fs, str):
        return fs, 0.0
    return fs.get("mode", ""), float(fs.get("delay_s", 0.0))


def heartbeat_delay_s() -> float:
    """Extra delay injected before each raylet heartbeat."""
    return spec().heartbeat_delay_s


_partition_anchor: Optional[float] = None


def partition_window(conn_name: str) -> Optional[Tuple[float, Optional[float]]]:
    """Absolute monotonic ``(start, end)`` of the partition window for
    connections named ``conn_name``, or None when the active spec has no
    partition fault matching it.  The window is anchored at the first
    *matching* consultation in this process (connections dial during
    daemon startup, so the anchor ≈ process start); ``end`` is None for a
    heal-less (permanent) partition.  The protocol layer consults this
    both to schedule the force-close of live matching connections and to
    refuse redials while the window is open."""
    global _partition_anchor
    p = spec().partition
    if not p or p.get("conn", "") not in (conn_name or ""):
        return None
    if _partition_anchor is None:
        _partition_anchor = time.monotonic()
    start = _partition_anchor + float(p.get("after_s", 0.0))
    heal = p.get("heal_s")
    return (start, None if heal is None else start + float(heal))


def partition_active(conn_name: str) -> bool:
    """True while ``conn_name`` is inside its partition window (dials must
    fail)."""
    win = partition_window(conn_name)
    if win is None:
        return False
    start, end = win
    now = time.monotonic()
    return now >= start and (end is None or now < end)


def make_drop_filter(conn_substr: str, every: int):
    """Frame filter for ``protocol.set_frame_fault``: drops every
    ``every``-th outgoing frame on connections whose name contains
    ``conn_substr``.  Deterministic: per-connection counters."""
    counts: Dict[int, int] = {}

    def _filter(conn, payload: bytes) -> bool:
        if conn_substr not in (conn.name or ""):
            return False
        n = counts.get(id(conn), 0) + 1
        counts[id(conn)] = n
        return every > 0 and n % every == 0

    return _filter


def corrupt_chunk(data: bytes) -> bytes:
    """Chaos hook for the raylet's fetch-serving path: bit-flip the first
    byte of every Nth chunk this process serves.  A single flipped bit is
    the minimal corruption — anything the checksum machinery misses here
    it would miss in the wild."""
    if not data or not _every_nth("corrupt_chunk", spec().corrupt_chunk):
        return data
    flipped = bytearray(data)
    flipped[0] ^= 0x01
    return bytes(flipped)


def drop_fetch_reply() -> bool:
    """Chaos hook at fetch_object entry: True when this request should
    fail.  The raylet raises (error reply) rather than staying silent so
    the puller sees a prompt per-candidate failure instead of parking on
    its RPC timeout."""
    return _every_nth("drop_fetch_reply", spec().drop_fetch_reply)


def truncate_spill(path: str) -> bool:
    """Chaos hook after a durable spill write: truncate every Nth spill
    file to ``keep`` (default half) of its on-disk size, simulating the
    torn write the header+fsync protocol exists to catch.  Returns True
    when the file was truncated."""
    fault = spec().truncate_spill
    if not _every_nth("truncate_spill", fault):
        return False
    keep = float(fault.get("keep", 0.5)) if isinstance(fault, dict) else 0.5
    try:
        size = os.path.getsize(path)
        os.truncate(path, max(0, int(size * keep)))
        return True
    except OSError:
        return False


# --------------------------------------------------------------- observers

def _list_nodes() -> List[dict]:
    from ray_tpu_torch.util import state
    return state.list_nodes()


def slow_client_delay_s() -> float:
    """Chaos hook in the ingress write path: seconds to stretch each
    socket drain (0.0 = fault inactive).  Injected INSIDE the drain the
    write timeout wraps, so a delay longer than the timeout
    deterministically trips the slow-client abort."""
    fault = spec().slow_client
    if not fault:
        return 0.0
    if isinstance(fault, dict):
        return float(fault.get("delay_s", 1.0))
    return float(fault)


def stall_stream_s() -> float:
    """Chaos hook in the replica stream path: seconds to stall before
    yielding the next streamed item.  ``{"after": N, "stall_s": X}``
    stalls exactly the Nth item this process yields (one-shot,
    deterministic) — long enough X trips the ingress stream-idle
    timeout mid-stream, after real tokens have already been sent."""
    fault = spec().stall_stream
    if not fault:
        return 0.0
    after = int(fault.get("after", 1)) if isinstance(fault, dict) else 1
    n = _counters.get("stall_stream", 0) + 1
    _counters["stall_stream"] = n
    if n == after:
        return float(fault.get("stall_s", 5.0)) \
            if isinstance(fault, dict) else 5.0
    return 0.0


def slow_ckpt_io_s() -> float:
    """Chaos hook in the checkpoint shard-write path: seconds to stretch
    each durable shard write (0.0 = fault inactive).  Injected inside
    ``CheckpointStore.save`` per shard, so a multi-shard checkpoint under
    fault takes long enough that the NEXT step's submit deterministically
    hits the async writer's one-in-flight backpressure."""
    fault = spec().slow_ckpt_io
    if not fault:
        return 0.0
    if isinstance(fault, dict):
        return float(fault.get("delay_s", 0.5))
    return float(fault)


_preempt_anchor: Optional[float] = None


def preempt_notice_at(rank: int) -> Optional[Tuple[float, float]]:
    """``(notice_time_monotonic, grace_s)`` for this train-worker process,
    or None when the active spec has no preempt fault targeting world
    rank ``rank``.  Anchored at the first matching consultation (workers
    consult at train-loop start, so the anchor ≈ loop start); the worker
    treats ``notice_time`` as the moment the platform's preemption signal
    lands and ``grace_s`` as the eviction deadline that follows."""
    global _preempt_anchor
    p = spec().preempt_notice
    if not p:
        return None
    want = p.get("rank")
    if want is not None and int(want) != int(rank):
        return None
    if _preempt_anchor is None:
        _preempt_anchor = time.monotonic()
    notice = _preempt_anchor + float(p.get("after_s", 0.0))
    return notice, float(p.get("grace_s", 30.0))


def stall_replica_decode_s() -> float:
    """Chaos hook in the inference engine's batch loop: seconds to stall
    before dispatching the next decode step.  ``{"after": N,
    "stall_s": X}`` stalls exactly the Nth step this process dispatches
    (one-shot, deterministic) — an X past RT_SERVE_STALL_S makes the
    replica look wedged to the ingress while its actor stays ALIVE,
    forcing the stall-detection half of mid-stream failover (replica
    death exercises the other half)."""
    fault = spec().stall_replica_decode
    if not fault:
        return 0.0
    after = int(fault.get("after", 1)) if isinstance(fault, dict) else 1
    n = _counters.get("stall_replica_decode", 0) + 1
    _counters["stall_replica_decode"] = n
    if n == after:
        return float(fault.get("stall_s", 60.0)) \
            if isinstance(fault, dict) else 60.0
    return 0.0


def wait_node_dead(node_id: str, timeout: float = 120.0) -> dict:
    """Block until the GCS records ``node_id`` as dead; returns its node
    record.  This is the recovery gate chaos tests key on — wall-clock
    sleeps race the health timeout, observed state does not.  Transient
    query errors (a GCS briefly saturated on a loaded box) are retried
    until the deadline, not propagated."""
    deadline = time.monotonic() + timeout
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            for n in _list_nodes():
                if n["node_id"] == node_id and not n["alive"]:
                    return n
            last_err = None
        except Exception as e:
            last_err = e
        time.sleep(0.25)
    raise TimeoutError(
        f"node {node_id[:12]} not marked dead within {timeout}s"
        + (f" (last query error: {last_err!r})" if last_err else ""))


def wait_alive_nodes(count: int, timeout: float = 120.0) -> List[dict]:
    """Block until exactly ``count`` nodes are alive per the GCS."""
    deadline = time.monotonic() + timeout
    alive: List[dict] = []
    while time.monotonic() < deadline:
        try:
            alive = [n for n in _list_nodes() if n["alive"]]
        except Exception:
            alive = []
        if len(alive) == count:
            return alive
        time.sleep(0.25)
    raise TimeoutError(
        f"expected {count} alive nodes within {timeout}s, have "
        f"{len(alive)}")


def wait_actor_dead(actor_id: str, timeout: float = 120.0) -> dict:
    """Block until the GCS records ``actor_id`` as DEAD; returns its
    actor record.  Same observed-state gating as wait_node_dead: chaos
    tests assert on recorded death, not on wall-clock sleeps."""
    from ray_tpu_torch.util import state
    deadline = time.monotonic() + timeout
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            for a in state.list_actors():
                if a.get("actor_id") == actor_id and \
                        a.get("state") == "DEAD":
                    return a
            last_err = None
        except Exception as e:
            last_err = e
        time.sleep(0.25)
    raise TimeoutError(
        f"actor {actor_id[:12]} not marked dead within {timeout}s"
        + (f" (last query error: {last_err!r})" if last_err else ""))


def kill_replica(deployment: Optional[str] = None, *,
                 index: Optional[int] = None,
                 actor_id: Optional[str] = None,
                 mode: str = "sigkill",
                 wait: bool = True,
                 timeout: float = 120.0) -> dict:
    """Kill one live serve replica mid-flight (chaos hook for the serving
    fleet: failover, rolling restart, circuit-breaker tests).

    Target selection: ``actor_id`` directly, or the ``index``-th (by
    name, default first) ALIVE replica named ``_serve:<deployment>:*``.
    ``mode="sigkill"`` SIGKILLs the hosting worker process — the abrupt
    death, mid-decode, that failover must absorb (same-host clusters
    only, like NodeKiller); it falls back to a GCS ``kill_actor`` when
    the pid isn't known yet.  ``mode="kill"`` always goes through the
    GCS.  With ``wait`` (default), returns only after the GCS records
    the death, so callers can immediately assert on recovery."""
    from ray_tpu_torch.util import state
    alive = [a for a in state.list_actors() if a.get("state") == "ALIVE"]
    if actor_id is not None:
        victims = [a for a in alive if a.get("actor_id") == actor_id]
    elif deployment is not None:
        prefix = f"_serve:{deployment}:"
        victims = sorted(
            (a for a in alive
             if (a.get("name") or "").startswith(prefix)),
            key=lambda a: a.get("name") or "")
        if index is not None:
            victims = victims[index:index + 1]
    else:
        raise ValueError("kill_replica needs deployment= or actor_id=")
    if not victims:
        raise RuntimeError(
            f"no live replica to kill (deployment={deployment!r}, "
            f"index={index}, actor_id={actor_id!r})")
    victim = victims[0]
    vid = victim["actor_id"]
    pid = None
    if mode == "sigkill":
        for w in state.list_workers():
            if w.get("actor_id") == vid and w.get("pid"):
                pid = w["pid"]
                break
        if pid is not None:
            os.kill(pid, signal.SIGKILL)
    if pid is None:   # mode == "kill", or the pid never reached the GCS
        state._gcs_request({"type": "kill_actor", "actor_id": vid,
                            "no_restart": True})
    record = {"actor_id": vid, "name": victim.get("name"),
              "pid": pid, "time": time.time()}
    if wait:
        wait_actor_dead(vid, timeout=timeout)
    return record


def kill_train_worker(group: Optional[str] = None, *,
                      rank: Optional[int] = None,
                      actor_id: Optional[str] = None,
                      mode: str = "sigkill",
                      wait: bool = True,
                      timeout: float = 120.0) -> dict:
    """Kill one live train-worker actor mid-step (chaos hook for the gang
    supervisor: unplanned-death recovery, restart-budget, deterministic-
    resume tests).

    Target selection: ``actor_id`` directly, or an ALIVE actor named
    ``_train:<group>:<rank>`` (the names the WorkerGroup registers; omit
    ``group`` to match any gang, omit ``rank`` for the lowest rank).
    ``mode="sigkill"`` SIGKILLs the hosting worker process — the abrupt
    mid-step death gang supervision must absorb (same-host clusters only,
    like NodeKiller); it falls back to a GCS ``kill_actor`` when the pid
    isn't known yet.  ``mode="kill"`` always goes through the GCS.  With
    ``wait`` (default), returns only after the GCS records the death, so
    callers can immediately assert on gang teardown/recovery."""
    from ray_tpu_torch.util import state
    alive = [a for a in state.list_actors() if a.get("state") == "ALIVE"]
    if actor_id is not None:
        victims = [a for a in alive if a.get("actor_id") == actor_id]
    else:
        prefix = f"_train:{group}:" if group is not None else "_train:"
        victims = sorted(
            (a for a in alive
             if (a.get("name") or "").startswith(prefix)),
            key=lambda a: a.get("name") or "")
        if rank is not None:
            victims = [a for a in victims
                       if (a.get("name") or "").endswith(f":{rank}")]
    if not victims:
        raise RuntimeError(
            f"no live train worker to kill (group={group!r}, "
            f"rank={rank}, actor_id={actor_id!r})")
    victim = victims[0]
    vid = victim["actor_id"]
    pid = None
    if mode == "sigkill":
        for w in state.list_workers():
            if w.get("actor_id") == vid and w.get("pid"):
                pid = w["pid"]
                break
        if pid is not None:
            os.kill(pid, signal.SIGKILL)
    if pid is None:   # mode == "kill", or the pid never reached the GCS
        state._gcs_request({"type": "kill_actor", "actor_id": vid,
                            "no_restart": True})
    record = {"actor_id": vid, "name": victim.get("name"),
              "pid": pid, "time": time.time()}
    if wait:
        wait_actor_dead(vid, timeout=timeout)
    return record


class NodeKiller:
    """Kills node daemons and waits for the GCS to observe the death.

    Plain class so a driver can use it inline; wrap with
    ``ray_tpu_torch.remote(NodeKiller)`` to run it inside the cluster like the
    reference NodeKillerActor (same-host clusters only: the kill is an
    ``os.kill`` of the daemon pid the raylet registered)."""

    def __init__(self):
        self.killed: List[dict] = []

    def alive_nodes(self, exclude_head: bool = True) -> List[dict]:
        return [n for n in _list_nodes()
                if n["alive"] and not (exclude_head and n.get("is_head"))]

    def kill_node(self, node_id: Optional[str] = None, *,
                  exclude_head: bool = True, wait: bool = True,
                  timeout: float = 120.0) -> dict:
        """SIGKILL the daemon of ``node_id`` (or the first live non-head
        node).  With ``wait`` (default), returns only after the GCS has
        marked the node dead — the caller can immediately assert on
        recovery behavior without racing the health check."""
        victims = self.alive_nodes(exclude_head=exclude_head)
        if node_id is not None:
            victims = [n for n in victims if n["node_id"] == node_id]
        victims = [n for n in victims if n.get("pid")]
        if not victims:
            raise RuntimeError(
                f"no killable node (node_id={node_id}, "
                f"exclude_head={exclude_head})")
        victim = victims[0]
        os.kill(victim["pid"], signal.SIGKILL)
        record = {"node_id": victim["node_id"], "pid": victim["pid"],
                  "time": time.time()}
        self.killed.append(record)
        if wait:
            wait_node_dead(victim["node_id"], timeout=timeout)
        return record

    def killed_nodes(self) -> List[dict]:
        return list(self.killed)
