"""`python -m ray_tpu_torch` CLI: cluster lifecycle, observability, jobs.

Port of ``ray_tpu/scripts/cli.py``.

Design analog: reference ``python/ray/scripts/scripts.py`` -- `ray start:529`,
`ray stop`, `ray status`, `ray list ...` (experimental/state CLI), `ray
timeline`, `ray memory`, `ray job submit/status/logs/stop/list`, `ray
microbenchmark`.

Cluster bookkeeping lives in a session file (default
``<tmp>/ray_tpu_torch/cluster.json``, never the JAX package's
``<tmp>/ray_tpu``) recording daemon PIDs + the GCS address, the CLI's
equivalent of the reference's ``/tmp/ray/ray_current_cluster``.  A head
started here advertises the cards its daemon finds (``GPU`` and
``accelerator_type:<name>``); ``--resources '{"GPU": 0}'`` opts out.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid

SESSION_DIR = os.environ.get(
    "RT_SESSION_DIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
SESSION_FILE = os.path.join(SESSION_DIR, "cluster.json")


def _load_session() -> dict:
    try:
        with open(SESSION_FILE) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {"nodes": []}


def _save_session(sess: dict):
    os.makedirs(SESSION_DIR, exist_ok=True)
    tmp = SESSION_FILE + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sess, f, indent=2)
    os.replace(tmp, SESSION_FILE)


def _connect(args):
    import ray_tpu_torch
    address = getattr(args, "address", None) or \
        os.environ.get("RT_ADDRESS") or _load_session().get("gcs_address")
    if not address:
        sys.exit("error: no running cluster found (no --address, RT_ADDRESS, "
                 f"or {SESSION_FILE})")
    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


# --------------------------------------------------------------- start/stop


def cmd_start(args):
    sess = _load_session()
    ready_file = os.path.join(
        SESSION_DIR, f"node_{uuid.uuid4().hex[:8]}.json")
    os.makedirs(SESSION_DIR, exist_ok=True)
    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.daemon_main",
           "--ready-file", ready_file,
           "--store-capacity", str(args.object_store_memory),
           "--no-parent-watch"]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    if args.head:
        cmd += ["--head", "--gcs-port", str(args.port),
                "--dashboard-port", str(args.dashboard_port),
                "--gcs-persist-path",
                os.path.join(SESSION_DIR, "gcs_snapshot.json")]
    else:
        address = args.address or sess.get("gcs_address")
        if not address:
            sys.exit("error: worker start needs --address (or a head in the "
                     "session file)")
        cmd += ["--gcs-address", address]
    log_path = os.path.join(SESSION_DIR,
                            f"daemon_{uuid.uuid4().hex[:8]}.log")
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
    deadline = time.monotonic() + 60
    while not os.path.exists(ready_file):
        if proc.poll() is not None:
            sys.exit(f"node daemon exited rc={proc.returncode}; "
                     f"log: {log_path}")
        if time.monotonic() > deadline:
            sys.exit(f"node daemon not ready after 60s; log: {log_path}")
        time.sleep(0.2)
    with open(ready_file) as f:
        info = json.load(f)
    sess.setdefault("nodes", []).append(
        {"pid": proc.pid, "node_id": info["node_id"], "head": args.head,
         "log": log_path})
    if args.head:
        sess["gcs_address"] = info["gcs_address"]
    _save_session(sess)
    print(f"node started: node_id={info['node_id']} pid={proc.pid}")
    if args.head:
        print(f"GCS address: {info['gcs_address']}")
        if info.get("dashboard_address"):
            print(f"dashboard: http://{info['dashboard_address']}/")
        print(f"connect with: ray_tpu_torch.init(address="
              f"\"{info['gcs_address']}\")"
              f"  # or RT_ADDRESS={info['gcs_address']}")
    if args.block:
        try:
            proc.wait()
        except KeyboardInterrupt:
            proc.terminate()


def cmd_stop(args):
    sess = _load_session()
    stopped = 0
    for node in sess.get("nodes", []):
        try:
            os.kill(node["pid"], signal.SIGTERM)
            stopped += 1
        except ProcessLookupError:
            pass
    # Head last is unnecessary: SIGTERM is graceful in daemon_main.
    for node in sess.get("nodes", []):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                os.kill(node["pid"], 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            try:
                os.kill(node["pid"], signal.SIGKILL)
            except ProcessLookupError:
                pass
    _save_session({"nodes": []})
    # A deliberate stop is a clean teardown: drop the GCS snapshot so the
    # next `start --head` is a fresh cluster, not a resurrection of the old
    # one's detached actors/jobs/KV. (Crash recovery keeps the snapshot
    # because the daemon dies without coming through here.)
    try:
        os.unlink(os.path.join(SESSION_DIR, "gcs_snapshot.json"))
    except OSError:
        pass
    print(f"stopped {stopped} node daemon(s)")


# ------------------------------------------------------------ observability


def cmd_status(args):
    rt = _connect(args)
    from ray_tpu_torch.util import state
    s = state.cluster_summary()
    print(json.dumps(s, indent=2, default=str))


def cmd_list(args):
    rt = _connect(args)
    from ray_tpu_torch.util import state
    fn = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
        "workers": state.list_workers,
    }[args.what]
    rows = fn()
    print(json.dumps(rows[:args.limit], indent=2, default=str))
    if len(rows) > args.limit:
        print(f"... {len(rows) - args.limit} more (use --limit)",
              file=sys.stderr)


def cmd_timeline(args):
    rt = _connect(args)
    events = rt.timeline(args.output)
    print(f"wrote {len(events)} events to {args.output}")


def cmd_memory(args):
    rt = _connect(args)
    from ray_tpu_torch.util import state
    print(json.dumps(state.list_objects(), indent=2, default=str))


def cmd_microbenchmark(args):
    from ray_tpu_torch._private.microbenchmark import main as bench_main
    bench_main()


def cmd_usage(args):
    _connect(args)
    import ray_tpu_torch
    print(json.dumps(ray_tpu_torch.usage_report(), indent=2, default=str))


def cmd_debug(args):
    """List active rpdb sessions and attach (reference: ``ray debug``)."""
    _connect(args)
    from ray_tpu_torch.util import rpdb
    sessions = rpdb.list_sessions()
    if not sessions:
        print("no active debugger sessions")
        return
    for i, s in enumerate(sessions):
        print(f"[{i}] pid {s['pid']}  {s['function']} at "
              f"{s['filename']}:{s['lineno']}  ({s['host']}:{s['port']})")
    idx = args.index
    if idx is None:
        if len(sessions) == 1:
            idx = 0
        else:
            idx = int(input("attach to which session? "))
    print(f"attaching to [{idx}]; type 'c' to continue the task")
    rpdb.connect(sessions[idx])


_LAUNCHERS: dict = {}   # cluster_name -> ClusterLauncher (this process)


def cmd_up(args):
    """Launch a cluster from a YAML config (reference: ray up)."""
    from ray_tpu_torch.autoscaler.launcher import (ClusterConfig,
                                                   ClusterLauncher)
    cfg = ClusterConfig.from_file(args.config_file)
    launcher = ClusterLauncher(cfg)
    launched = launcher.up(start_monitor=not args.no_monitor)
    _LAUNCHERS[cfg.cluster_name] = launcher
    print(json.dumps({"cluster": cfg.cluster_name, "launched": launched}))
    if not args.no_monitor and not args.no_block:
        print("autoscaler monitor running; Ctrl-C to tear down")
        try:
            import time as _t
            while True:
                _t.sleep(3600)
        except KeyboardInterrupt:
            n = launcher.down()
            print(f"terminated {n} nodes")


def cmd_down(args):
    from ray_tpu_torch.autoscaler.launcher import (ClusterConfig,
                                                   ClusterLauncher)
    cfg = ClusterConfig.from_file(args.config_file)
    launcher = _LAUNCHERS.pop(cfg.cluster_name, None) or \
        ClusterLauncher(cfg)
    n = launcher.down()
    print(f"terminated {n} nodes of cluster {cfg.cluster_name}")


def cmd_serve(args):
    """serve deploy/status/delete/shutdown (reference: serve CLI in
    python/ray/serve/scripts.py over the REST schema)."""
    _connect(args)
    from ray_tpu_torch import serve
    if args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.schema import (ServeApplicationSchema,
                                                deploy_application)
        st = deploy_application(ServeApplicationSchema.from_file(
            args.config_file))
        print(json.dumps(st, indent=2, default=str))
    elif args.serve_cmd == "status":
        print(json.dumps(serve.status(), indent=2, default=str))
    elif args.serve_cmd == "delete":
        serve.delete(args.name)
        print(f"deleted: {args.name}")
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")


# --------------------------------------------------------------------- jobs


def cmd_job(args):
    from ray_tpu_torch.job import JobSubmissionClient
    client = JobSubmissionClient(
        getattr(args, "address", None) or
        os.environ.get("RT_ADDRESS") or _load_session().get("gcs_address"))
    if args.job_cmd == "submit":
        import shlex
        ep = args.entrypoint
        if ep and ep[0] == "--":
            ep = ep[1:]
        renv = None
        if getattr(args, "runtime_env_json", None):
            renv = json.loads(args.runtime_env_json)
        sid = client.submit_job(entrypoint=shlex.join(ep),
                                runtime_env=renv)
        print(f"submitted: {sid}")
        if args.wait:
            status = client.wait_until_finished(sid, timeout=args.timeout)
            print(client.get_job_logs(sid), end="")
            print(f"status: {status}")
            sys.exit(0 if status == "SUCCEEDED" else 1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.id), end="")
    elif args.job_cmd == "stop":
        print(client.stop_job(args.id))
    elif args.job_cmd == "list":
        for info in client.list_jobs():
            print(f"{info.submission_id}  {info.status:10s}  "
                  f"{info.entrypoint}")


# --------------------------------------------------------------------- main


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a node daemon on this host")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="GCS address to join (worker nodes)")
    sp.add_argument("--port", type=int, default=6380,
                    help="GCS port (head only)")
    sp.add_argument("--dashboard-port", type=int, default=8265,
                    help="HTTP dashboard port (head only; -1 disables)")
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--resources", help="JSON resource dict")
    sp.add_argument("--object-store-memory", type=int,
                    default=512 * 1024 * 1024)
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop all node daemons in the session")
    sp.set_defaults(fn=cmd_stop)

    for name, fn in [("status", cmd_status)]:
        sp = sub.add_parser(name)
        sp.add_argument("--address")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("what", choices=["nodes", "actors", "tasks", "objects",
                                     "placement-groups", "workers"])
    sp.add_argument("--address")
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("usage", help="print the local usage report")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_usage)

    sp = sub.add_parser("timeline", help="dump Chrome trace of task events")
    sp.add_argument("--address")
    sp.add_argument("--output", default="timeline.json")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("memory", help="dump the cluster object directory")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("microbenchmark", help="run the perf microbenchmark")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("up", help="launch a cluster from a YAML config")
    sp.add_argument("config_file")
    sp.add_argument("--no-monitor", action="store_true",
                    help="bootstrap min_workers only; no autoscaling loop")
    sp.add_argument("--no-block", action="store_true",
                    help="return immediately after bootstrap")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a launched cluster")
    sp.add_argument("config_file")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("serve", help="manage Serve deployments")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    s = ssub.add_parser("deploy")
    s.add_argument("config_file", help="YAML/JSON application config")
    s.add_argument("--address")
    for name in ("status", "shutdown"):
        s = ssub.add_parser(name)
        s.add_argument("--address")
    s = ssub.add_parser("delete")
    s.add_argument("name")
    s.add_argument("--address")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("debug",
                        help="attach to an rpdb breakpoint in a worker")
    sp.add_argument("--address")
    sp.add_argument("--index", type=int, default=None,
                    help="session index (default: prompt, or 0 if single)")
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("job")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--address")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("--runtime-env-json", dest="runtime_env_json",
                   help='JSON runtime env, e.g. '
                        '\'{"working_dir": ".", "pip": [...]}\'')
    j.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="shell command to run as the job driver")
    for name in ["status", "logs", "stop"]:
        j = jsub.add_parser(name)
        j.add_argument("id")
        j.add_argument("--address")
    j = jsub.add_parser("list")
    j.add_argument("--address")
    sp.set_defaults(fn=cmd_job)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
