"""Dashboard: HTTP/JSON observability endpoint on the head node.

Design analog: reference ``dashboard/`` (DashboardHead head.py:70 + REST
modules + StateAggregator).  Scope here is the REST surface the state CLI
and external monitors consume, plus a dependency-free single-file live UI
at ``/`` (auto-refreshing summary cards + node/actor/job/task tables) in
place of the reference's React client; the JSON endpoints mirror
``ray list ...``/``ray summary`` and Prometheus-style metrics.  Implemented
as a dependency-free asyncio HTTP/1.1 GET server co-hosted with the GCS
(direct in-process table reads, no RPC hop).

Routes:
  GET /api/nodes | /api/actors | /api/tasks | /api/objects
      /api/placement_groups | /api/jobs | /api/cluster_summary
  GET /api/metrics      (Prometheus text exposition)
  GET /                 (live HTML dashboard)
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)


class DashboardHttpServer:
    def __init__(self, gcs):
        self.gcs = gcs
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._on_client, host="127.0.0.1", port=port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- serving

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10)
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2 or parts[0] != "GET":
                await self._respond(writer, 405, b"method not allowed",
                                    "text/plain")
                return
            path, _, query = parts[1].partition("?")
            # Drain headers (ignored).
            while True:
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
            await self._route(writer, path, query)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _respond(self, writer, status: int, body: bytes,
                       ctype: str = "application/json"):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed"}.get(status, "")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()

    async def _route(self, writer, path: str, query: str = ""):
        g = self.gcs
        if path == "/":
            await self._respond(writer, 200, _INDEX_HTML, "text/html")
            return
        if path == "/api/metrics":
            await self._respond(writer, 200, self._prometheus().encode(),
                                "text/plain; version=0.0.4")
            return
        if path == "/api/profile":
            # /api/profile?pid=<pid>[&duration=<s>] -> live stack summary
            # of that worker (reference: dashboard worker profiling via
            # the per-node agent, modules/reporter/profile_manager.py).
            from urllib.parse import parse_qs
            q = parse_qs(query)
            if "pid" not in q:
                await self._respond(writer, 400,
                                    b'{"error": "pid= required"}')
                return
            try:
                out = await g._h_profile_worker(None, {
                    "pid": int(q["pid"][0]),
                    "duration": float(q.get("duration", ["3"])[0]),
                })
                await self._respond(writer, 200,
                                    json.dumps(out, default=str).encode())
            except (ValueError, TypeError) as e:
                await self._respond(writer, 400, json.dumps(
                    {"error": f"bad parameters: {e}"}).encode())
            except Exception as e:  # noqa: BLE001 - node died mid-profile
                await self._respond(writer, 200, json.dumps(
                    {"ok": False, "error": repr(e)}).encode())
            return
        if path == "/api/serve":
            # Controller-published status from GCS KV (see
            # ServeController._publish_status).
            raw = g.kv.get("serve", {}).get(b"status")
            await self._respond(
                writer, 200,
                raw if raw else b'{"deployments": {}}')
            return
        data = None
        if path == "/api/node_stats":
            data = g.node_stats
        elif path == "/api/nodes":
            data = [n.public() for n in g.nodes.values()]
        elif path == "/api/actors":
            data = [a.public() for a in g.actors.values()]
        elif path == "/api/tasks":
            data = list(g.task_events)
        elif path == "/api/objects":
            data = [{"object_id": oid, "owner": e.owner,
                     "locations": sorted(e.nodes),
                     "spilled": dict(e.spilled)}
                    for oid, e in g.object_dir.items()]
        elif path == "/api/placement_groups":
            data = [pg.public() for pg in g.placement_groups.values()]
        elif path == "/api/jobs":
            data = list(g.jobs.values())
        elif path == "/api/cluster_summary":
            data = self._summary()
        if data is None:
            await self._respond(writer, 404, b'{"error": "not found"}')
            return
        await self._respond(writer, 200,
                            json.dumps(data, default=str).encode())

    def _summary(self) -> dict:
        g = self.gcs
        total: dict = {}
        avail: dict = {}
        for n in g.nodes.values():
            if not n.alive:
                continue
            for k, v in n.resources_total.items():
                total[k] = total.get(k, 0.0) + v
            for k, v in n.resources_available.items():
                avail[k] = avail.get(k, 0.0) + v
        by_status: dict = {}
        for ev in g.task_events:
            by_status[ev.get("status", "?")] = \
                by_status.get(ev.get("status", "?"), 0) + 1
        return {
            "time": time.time(),
            "nodes": {"alive": sum(1 for n in g.nodes.values() if n.alive),
                      "dead": sum(1 for n in g.nodes.values()
                                  if not n.alive)},
            "resources": {"total": total, "available": avail},
            "actors": {"total": len(g.actors),
                       "alive": sum(1 for a in g.actors.values()
                                    if a.state == "ALIVE")},
            "tasks": {"by_status": by_status},
            "objects": len(g.object_dir),
            "placement_groups": len(g.placement_groups),
        }

    def _prometheus(self) -> str:
        """Cluster gauges + user metrics in Prometheus text exposition
        (reference: metrics agent's OpenCensus->Prometheus export)."""
        s = self._summary()
        lines = [
            "# TYPE ray_tpu_nodes_alive gauge",
            f"ray_tpu_nodes_alive {s['nodes']['alive']}",
            "# TYPE ray_tpu_actors_alive gauge",
            f"ray_tpu_actors_alive {s['actors']['alive']}",
            "# TYPE ray_tpu_objects_tracked gauge",
            f"ray_tpu_objects_tracked {s['objects']}",
        ]
        from ray_tpu_torch.util.metrics import _escape_label, render_prometheus
        for k, v in s["resources"]["available"].items():
            lines.append(f'ray_tpu_resource_available'
                         f'{{resource="{_escape_label(k)}"}} {v}')
        # Control-plane liveness: event-loop lag of the GCS (its own
        # watchdog, in-process) and of every raylet (ridden in over node
        # stats).  Rendered through the shared exposition renderer with
        # the built-in prefix — these are system series, not user metrics.
        lag_records = []
        wd = getattr(self.gcs, "_watchdog", None)
        if wd is not None:
            lag_records.append({
                "name": "loop_lag_ms", "type": "gauge",
                "labels": {"component": "gcs"}, "value": wd.last_lag_ms})
        for node_id, st in self.gcs.node_stats.items():
            if "loop_lag_ms" in st:
                lag_records.append({
                    "name": "loop_lag_ms", "type": "gauge",
                    "labels": {"component": "raylet",
                               "node_id": node_id},
                    "value": st["loop_lag_ms"]})
        # Data-plane health (alongside loop_lag_ms): per-node corruption
        # detections, pull retry rounds, and spill fsync time from node
        # stats, plus the GCS-side corruption strikes AGAINST each node
        # (these outlive the node — a holder that served garbage and died
        # is still part of the story).
        # Control-plane partition counters ride the same stream: GCS
        # redials, degraded-mode entries, and resync re-advertisements.
        for node_id, st in self.gcs.node_stats.items():
            for name in ("spilled_objects", "restored_objects",
                         "objects_corrupted", "pull_retries",
                         "spill_fsync_ms", "gcs_reconnects",
                         "node_disconnects",
                         "resync_objects_readvertised",
                         "autotune_cache_hits", "autotune_cache_misses",
                         "autotune_tune_ms",
                         "router_retries", "circuit_open",
                         "streams_resumed", "drain_handoffs",
                         "ctrl_reresolves",
                         "train_recoveries", "preemptions",
                         "ckpt_write_ms", "ckpt_restore_ms",
                         "ckpt_corrupt_skipped"):
                if name in st:
                    lag_records.append({
                        "name": name, "type": "counter",
                        "labels": {"node_id": node_id},
                        "value": st[name]})
        for node_id, strikes in getattr(
                self.gcs, "object_invalidations", {}).items():
            lag_records.append({
                "name": "object_location_invalidations", "type": "counter",
                "labels": {"node_id": node_id}, "value": strikes})
        # User metrics: reuse the GCS's (name, labels) aggregation and the
        # shared exposition renderer (which sanitizes names) — per-process
        # raw records would emit duplicate series and drop histogram
        # buckets, and any per-endpoint renaming would give one metric two
        # series names depending on scrape point.
        # Autotune, serve-resilience, and train-resilience counters flow
        # through the user-metrics pipe (worker processes flush them like
        # any Counter) but are SYSTEM series: split them out under the
        # ray_tpu_ prefix so operators find cache hit rate, failover
        # counts, and checkpoint health next to the other health
        # series, not namespaced as user metrics.
        _SERVE_COUNTERS = ("router_retries", "circuit_open",
                           "streams_resumed", "drain_handoffs",
                           "ctrl_reresolves")
        _TRAIN_COUNTERS = ("train_recoveries", "preemptions",
                           "ckpt_write_ms", "ckpt_restore_ms",
                           "ckpt_corrupt_skipped")
        agg = self.gcs.aggregated_metrics()
        system = [m for m in agg
                  if str(m.get("name", "")).startswith("autotune_")
                  or str(m.get("name", "")) in _SERVE_COUNTERS
                  or str(m.get("name", "")) in _TRAIN_COUNTERS]
        user = [m for m in agg if m not in system]
        return "\n".join(lines) + "\n" + \
            render_prometheus(lag_records + system, prefix="ray_tpu_") + \
            render_prometheus(user)


# Single-file live UI (reference: the dashboard/client React app, scaled to
# one dependency-free page): auto-refreshing cluster summary, node/actor/
# job tables, and recent task activity, all straight off /api/*.
_INDEX_HTML = b"""<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f5f6f8;color:#1c2126}
 header{background:#1c2126;color:#fff;padding:10px 20px;display:flex;align-items:baseline;gap:16px}
 header h1{font-size:16px;margin:0} header span{color:#9aa4ad;font-size:12px}
 main{padding:16px 20px;max-width:1100px;margin:auto}
 .cards{display:flex;gap:12px;flex-wrap:wrap;margin-bottom:16px}
 .card{background:#fff;border-radius:8px;padding:10px 16px;box-shadow:0 1px 2px rgba(0,0,0,.08);min-width:110px}
 .card b{display:block;font-size:22px} .card span{font-size:12px;color:#67707a}
 h2{font-size:13px;text-transform:uppercase;letter-spacing:.05em;color:#67707a;margin:18px 0 6px}
 table{width:100%;border-collapse:collapse;background:#fff;border-radius:8px;overflow:hidden;box-shadow:0 1px 2px rgba(0,0,0,.08);font-size:13px}
 th,td{text-align:left;padding:6px 10px;border-bottom:1px solid #eef0f2;white-space:nowrap;overflow:hidden;text-overflow:ellipsis;max-width:260px}
 th{background:#fafbfc;font-weight:600;color:#49525b}
 .ok{color:#0a7d33;font-weight:600} .bad{color:#b3261e;font-weight:600}
 footer{color:#9aa4ad;font-size:11px;padding:14px 20px}
</style></head><body>
<header><h1>ray_tpu_torch dashboard</h1><span id=upd></span>
<span><a href="/api/metrics" style="color:#9ec5fe">prometheus</a></span></header>
<main>
 <div class=cards id=cards></div>
 <h2>Nodes</h2><table id=nodes></table>
 <h2>Workers (per node)</h2><table id=workers></table>
 <h2>Actors</h2><table id=actors></table>
 <h2>Jobs</h2><table id=jobs></table>
 <h2>Recent tasks</h2><table id=tasks></table>
</main>
<footer>auto-refreshes every 2s &middot; raw endpoints: /api/nodes /api/actors
/api/tasks /api/objects /api/placement_groups /api/jobs /api/cluster_summary</footer>
<script>
const J=(u)=>fetch(u).then(r=>r.json());
const esc=(s)=>String(s??"").replace(/[&<>]/g,c=>({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
function tbl(el,heads,rows){
 el.innerHTML="<tr>"+heads.map(h=>"<th>"+h+"</th>").join("")+"</tr>"+
  rows.map(r=>"<tr>"+r.map(c=>"<td>"+c+"</td>").join("")+"</tr>").join("");
}
async function tick(){
 try{
  const [sum,nodes,actors,jobs,tasks,nstats]=await Promise.all([
    J("/api/cluster_summary"),J("/api/nodes"),J("/api/actors"),
    J("/api/jobs"),J("/api/tasks"),J("/api/node_stats")]);
  const res=(sum.resources||{}).total||{}; const cards=document.getElementById("cards");
  const card=(v,l)=>`<div class=card><b>${v}</b><span>${l}</span></div>`;
  cards.innerHTML=card((sum.nodes||{}).alive??nodes.filter(n=>n.alive).length,"nodes alive")
   +card((sum.actors||{}).alive??actors.filter(a=>a.state=="ALIVE").length,"actors alive")
   +card(res.CPU??"-","CPUs")+card(res.GPU??"-","GPUs")
   +card(tasks.length,"task events");
  tbl(document.getElementById("nodes"),["node","address","alive","resources"],
   nodes.map(n=>[esc((n.node_id||"").slice(0,12)),esc(n.address),
    n.alive?'<span class=ok>alive</span>':'<span class=bad>dead</span>',
    esc(JSON.stringify(n.resources_total||n.resources||{}))]));
  const wrows=[];
  for(const [nid,st] of Object.entries(nstats||{})){
   const store=st.object_store||{};
   for(const w of (st.workers||[])){
    wrows.push([esc(nid.slice(0,12)),w.pid,esc((w.actor_id||"").slice(0,12)),
     w.busy?'<span class=bad>busy</span>':'<span class=ok>idle</span>',
     w.cpu_percent+"%",(w.rss_bytes/1048576).toFixed(1)+" MB",
     `<a href="/api/profile?pid=${w.pid}&duration=3" target=_blank>profile</a>`]);
   }
   wrows.push([esc(nid.slice(0,12)),"&mdash;","node load "+
    (st.load_avg||[]).map(x=>x.toFixed(2)).join(" / "),"",
    "store "+((store.bytes_used??0)/1048576).toFixed(1)+" MB",
    "mem avail "+((st.mem_available??0)/1073741824).toFixed(2)+" GB",""]);
  }
  tbl(document.getElementById("workers"),
   ["node","pid","actor","state","cpu","rss","" ],wrows.slice(0,60));
  tbl(document.getElementById("actors"),["actor","name","state","node"],
   actors.slice(0,50).map(a=>[esc((a.actor_id||"").slice(0,12)),esc(a.name||""),
    a.state=="ALIVE"?'<span class=ok>ALIVE</span>':'<span class=bad>'+esc(a.state)+'</span>',
    esc((a.node_id||"").slice(0,12))]));
  tbl(document.getElementById("jobs"),["job","state","started"],
   jobs.slice(0,30).map(j=>[esc(j.job_id||""),esc(j.state||""),
    j.start_time?new Date(j.start_time*1000).toLocaleTimeString():""]));
  tbl(document.getElementById("tasks"),["name","kind","status","duration"],
   tasks.slice(-30).reverse().map(t=>[esc(t.name||""),esc(t.kind||""),
    t.status=="FINISHED"?'<span class=ok>FINISHED</span>':'<span class=bad>'+esc(t.status)+'</span>',
    ((t.end-t.start)*1000).toFixed(1)+" ms"]));
  document.getElementById("upd").textContent="updated "+new Date().toLocaleTimeString();
 }catch(e){document.getElementById("upd").textContent="refresh failed: "+e;}
}
tick(); setInterval(tick,2000);
</script></body></html>
"""
