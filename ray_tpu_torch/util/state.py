"""State observability API.

Reference analogs: ``python/ray/experimental/state/api.py`` —
list_actors:736, list_tasks:959, list_objects:1003 — backed by
GcsTaskManager task events, plus ``ray status``/``ray summary`` views and
the Chrome-trace timeline dump (``_private/state.py:435``
chrome_tracing_dump).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _gcs_request(msg: dict):
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request(msg)


def list_nodes() -> List[Dict[str, Any]]:
    return _gcs_request({"type": "get_nodes"})


def list_actors() -> List[Dict[str, Any]]:
    return _gcs_request({"type": "list_actors"})


def list_tasks(limit: int = 20000, *, offset: int = 0,
               name: Optional[str] = None, status: Optional[str] = None,
               kind: Optional[str] = None,
               trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finished/failed task executions from the GCS task-event log.

    Filters (name/status/kind) are pushed down to the GCS and applied
    before the (offset, limit) page — newest first — so large retention
    windows never ship to the driver wholesale (reference state API
    server-side filtering; the event store itself is a bounded deque of
    ``task_event_retention`` entries)."""
    return _gcs_request({"type": "list_task_events", "limit": limit,
                         "offset": offset, "name": name, "status": status,
                         "kind": kind, "trace_id": trace_id})


def node_stats() -> Dict[str, Dict[str, Any]]:
    """Latest per-node agent report (workers, load, memory, object store,
    ``loop_lag_ms``, and the data-plane health counters
    ``objects_corrupted`` / ``pull_retries`` / ``spill_fsync_ms``) keyed
    by node id.  Dead nodes' lifetime spill counters arrive separately in
    the RPC's ``dead_totals`` field — use spill_totals() /
    data_plane_totals() for the cluster-wide lifetime sums."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    return reply.get("nodes", {})


def list_workers() -> List[Dict[str, Any]]:
    """Per-node worker processes (pid, cpu, rss, role) from the raylet
    stats stream (reference: `ray list workers` over per-node agents)."""
    out: List[Dict[str, Any]] = []
    for node_id, s in node_stats().items():
        for w in s.get("workers", []):
            out.append({"node_id": node_id, **w})
    return out


def spill_totals() -> Dict[str, int]:
    """Cluster-wide lifetime spill/restore object counts, summed over the
    raylets' periodic stats pushes (refresh interval ~2s, so totals lag
    live activity by up to one push).  Includes counters carried over
    from dead nodes (the GCS's ``dead_totals`` field)."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    return {"spilled_objects": dead.get("spilled_objects", 0) +
            sum(s.get("spilled_objects", 0) for s in stats.values()),
            "restored_objects": dead.get("restored_objects", 0) +
            sum(s.get("restored_objects", 0) for s in stats.values())}


def data_plane_totals() -> Dict[str, Any]:
    """Cluster-wide lifetime object data-plane health counters: checksum
    mismatches detected (``objects_corrupted``), extra pull rounds
    (``pull_retries``), cumulative spill fsync time (``spill_fsync_ms``)
    — summed over live nodes plus the dead-node carry-over — and the
    GCS's per-node corruption-strike map (``invalidations_by_node``:
    checksum-mismatch invalidations reported AGAINST each node)."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    out: Dict[str, Any] = {}
    for k in ("objects_corrupted", "pull_retries", "spill_fsync_ms"):
        out[k] = dead.get(k, 0) + sum(s.get(k, 0) for s in stats.values())
    out["invalidations_by_node"] = reply.get("invalidations", {})
    return out


def control_plane_totals() -> Dict[str, Any]:
    """Cluster-wide lifetime control-plane partition counters: successful
    GCS redials (``gcs_reconnects``), entries into DISCONNECTED degraded
    mode (``node_disconnects``), and object locations re-advertised by
    post-reconnect resyncs (``resync_objects_readvertised``) — summed over
    live nodes plus the dead-node carry-over."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    out: Dict[str, Any] = {}
    for k in ("gcs_reconnects", "node_disconnects",
              "resync_objects_readvertised"):
        out[k] = dead.get(k, 0) + sum(s.get(k, 0) for s in stats.values())
    return out


def autotune_totals() -> Dict[str, Any]:
    """Cluster-wide kernel-autotune counters: cache ``hits``/``misses``
    and cumulative tuning wall-clock (``autotune_tune_ms``), combining
    raylet-side counts ridden in over node stats (live + dead-node
    carry-over) with the worker-process counters aggregated through the
    user-metrics pipe (raylets never flush user metrics, so the two
    sources never double count)."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    out: Dict[str, Any] = {}
    for k in ("autotune_cache_hits", "autotune_cache_misses",
              "autotune_tune_ms"):
        out[k] = dead.get(k, 0) + sum(s.get(k, 0) for s in stats.values())
    try:
        agg = _gcs_request({"type": "list_metrics"}) or []
        for m in agg:
            name = str(m.get("name", ""))
            if name in out and m.get("type") == "counter":
                out[name] += m.get("value", 0)
    except Exception:
        pass
    return out


def serve_totals() -> Dict[str, Any]:
    """Cluster-wide serve-resilience counters: requests re-routed after a
    retryable failure (``router_retries``), circuit-breaker ejections
    (``circuit_open``), SSE streams failed over and resumed mid-decode
    (``streams_resumed``), and in-flight streams force-handed to failover
    at a drain deadline (``drain_handoffs``) — combining raylet-side
    counts ridden in over node stats (live + dead-node carry-over) with
    the counters of the processes that actually route (ingress actors,
    the controller, handle-holding workers) aggregated through the
    user-metrics pipe (raylets never flush user metrics, so the two
    sources never double count)."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    out: Dict[str, Any] = {}
    for k in ("router_retries", "circuit_open", "streams_resumed",
              "drain_handoffs", "ctrl_reresolves"):
        out[k] = dead.get(k, 0) + sum(s.get(k, 0) for s in stats.values())
    try:
        agg = _gcs_request({"type": "list_metrics"}) or []
        for m in agg:
            name = str(m.get("name", ""))
            if name in out and m.get("type") == "counter":
                out[name] += m.get("value", 0)
    except Exception:
        pass
    return out


def train_totals() -> Dict[str, Any]:
    """Cluster-wide training-resilience counters: gang restarts after an
    unplanned worker death (``train_recoveries``), planned preemption
    handoffs (``preemptions``), cumulative durable checkpoint write and
    verified restore wall-clock (``ckpt_write_ms`` / ``ckpt_restore_ms``),
    and checkpoints rejected by CRC/manifest verification at restore
    (``ckpt_corrupt_skipped``) — combining raylet-side counts ridden in
    over node stats (live + dead-node carry-over) with the counters of
    the processes that actually train (worker actors, the driver
    supervisor) aggregated through the user-metrics pipe (raylets never
    flush user metrics, so the two sources never double count)."""
    reply = _gcs_request({"type": "get_node_stats"}) or {}
    stats = reply.get("nodes", {})
    dead = reply.get("dead_totals", {})
    out: Dict[str, Any] = {}
    for k in ("train_recoveries", "preemptions", "ckpt_write_ms",
              "ckpt_restore_ms", "ckpt_corrupt_skipped"):
        out[k] = dead.get(k, 0) + sum(s.get(k, 0) for s in stats.values())
    try:
        agg = _gcs_request({"type": "list_metrics"}) or []
        for m in agg:
            name = str(m.get("name", ""))
            if name in out and m.get("type") == "counter":
                out[name] += m.get("value", 0)
    except Exception:
        pass
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Objects registered in the cluster object directory (plasma-sized;
    inline objects live in their owners and are not globally tracked)."""
    return _gcs_request({"type": "list_objects"})


def list_placement_groups() -> List[Dict[str, Any]]:
    return _gcs_request({"type": "list_placement_groups"})


def cluster_summary() -> Dict[str, Any]:
    """`ray summary`-style rollup: nodes, resources, actors, task stats."""
    nodes = list_nodes()
    actors = list_actors()
    tasks = list_tasks()
    res = _gcs_request({"type": "cluster_resources"})
    by_status: Dict[str, int] = {}
    by_name: Dict[str, Dict[str, Any]] = {}
    for t in tasks:
        by_status[t["status"]] = by_status.get(t["status"], 0) + 1
        agg = by_name.setdefault(t.get("name") or "?", {
            "count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += max(0.0, t["end"] - t["start"])
    return {
        "nodes": {"alive": sum(1 for n in nodes if n["alive"]),
                  "dead": sum(1 for n in nodes if not n["alive"])},
        "resources": res,
        "actors": {"total": len(actors),
                   "alive": sum(1 for a in actors
                                if a["state"] == "ALIVE")},
        "tasks": {"by_status": by_status, "by_name": by_name},
    }


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome trace (chrome://tracing / perfetto) of task executions
    (reference: `ray timeline`, _private/state.py:435).

    Rows: pid = node, tid = worker process (or actor).  Returns the event
    list; writes JSON to `filename` when given.
    """
    events = list_tasks()
    trace = []
    for e in events:
        tid = e.get("actor_id") or f"worker-{e.get('pid')}"
        trace.append({
            "ph": "X",
            "name": e.get("name") or e.get("kind"),
            "cat": e.get("kind", "task"),
            "pid": f"node-{(e.get('node_id') or '')[:8]}",
            "tid": tid,
            "ts": e["start"] * 1e6,          # chrome wants microseconds
            "dur": max(0.0, e["end"] - e["start"]) * 1e6,
            "args": {"task_id": e.get("task_id"),
                     "status": e.get("status")},
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
