"""Node daemon process: hosts the raylet (and, on the head node, the GCS).

Design analog: reference ``python/ray/_private/node.py`` +
``src/ray/raylet/main.cc`` / ``src/ray/gcs/gcs_server/gcs_server_main.cc``.
The reference spawns gcs_server and raylet as separate processes; we co-host
the GCS inside the head node's daemon process (they still talk over a real
socket, preserving the rpc boundary) to keep process count sane on one host.

Invoked as:  python -m ray_tpu_torch._private.daemon_main --ready-file F [--head]
             [--gcs-address HOST:PORT] [--resources JSON] ...
"""

from __future__ import annotations

import argparse
import asyncio

from ray_tpu_torch._private.async_utils import spawn
import json
import logging
import os
import signal
import sys
from typing import Dict, List, Tuple

from ray_tpu_torch._private import gpu_topology
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.raylet import Raylet

logger = logging.getLogger(__name__)


def node_resources(args) -> Tuple[Dict[str, float], List[str]]:
    """The node's resources and the card ids its workers may be leased.

    GPU discovery (reference: GPU autodetect, _private/resource_spec.py)
    runs before the event loop starts: it may wait on nvidia-smi.  Only
    the head claims real cards (simulated nodes of one host would
    otherwise each claim the same ones); explicit resources win."""
    resources = json.loads(args.resources) if args.resources else {}
    if "CPU" not in resources:
        resources["CPU"] = float(os.cpu_count() or 1)
    resources.setdefault("node", 1.0)
    gpu_ids: List[str] = []
    if args.head and not args.no_gpu_detect:
        gpu_ids, found = gpu_topology.detect()
        resources = {**found, **resources}
    num_gpus = int(resources.get("GPU", 0))
    if num_gpus != resources.get("GPU", 0):
        raise ValueError(f"GPU must be a whole number, got "
                         f"{resources['GPU']}")
    if len(gpu_ids) != num_gpus:
        gpu_ids = [str(i) for i in range(num_gpus)]
    return resources, gpu_ids


async def amain(args, resources: Dict[str, float],
                gpu_ids: List[str]) -> None:
    node_id = NodeID.from_random()
    gcs = None
    dashboard = None
    dashboard_address = None
    if args.head:
        gcs = GcsServer(persist_path=args.gcs_persist_path)
        gcs_port = await gcs.start(args.gcs_port)
        gcs_address = f"127.0.0.1:{gcs_port}"
        if args.dashboard_port >= 0:
            # Best-effort: a taken port (another cluster's dashboard on
            # 8265) must not abort head startup over observability.
            try:
                from ray_tpu_torch.dashboard import DashboardHttpServer
                dashboard = DashboardHttpServer(gcs)
                dport = await dashboard.start(args.dashboard_port)
                dashboard_address = f"127.0.0.1:{dport}"
            except OSError as e:
                logger.warning("dashboard disabled: port %s unavailable "
                               "(%s)", args.dashboard_port, e)
                dashboard = None
    else:
        gcs_address = args.gcs_address

    worker_env = json.loads(args.worker_env) if args.worker_env else {}
    raylet = Raylet(
        node_id=node_id,
        gcs_address=gcs_address,
        resources=resources,
        store_capacity=args.store_capacity,
        is_head=args.head,
        worker_env=worker_env,
        labels=json.loads(args.labels) if args.labels else None,
        gpu_ids=gpu_ids,
    )
    raylet_port = await raylet.start(0)

    ready = {
        "node_id": node_id.hex(),
        "gcs_address": gcs_address,
        "raylet_address": f"127.0.0.1:{raylet_port}",
        "store_name": raylet.store_name,
        "pid": os.getpid(),
        "dashboard_address": dashboard_address,
    }
    def _write_ready():
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ready, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.ready_file)

    # The raylet/GCS serve on this loop already — even the one-shot
    # ready-file write goes through the executor.
    await asyncio.get_running_loop().run_in_executor(None, _write_ready)

    stop = asyncio.Event()

    def _sig(*_):
        stop.set()

    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, _sig)
    asyncio.get_running_loop().add_signal_handler(signal.SIGINT, _sig)

    # Exit if our parent (the driver or cluster launcher) disappears.
    ppid = os.getppid()

    async def watch_parent():
        while True:
            if os.getppid() != ppid:
                stop.set()
                return
            await asyncio.sleep(1.0)

    if not args.no_parent_watch:
        spawn(watch_parent(), name="daemon-parent-watch")
    await stop.wait()
    await raylet.close()
    if dashboard is not None:
        await dashboard.close()
    if gcs is not None:
        await gcs.close()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", action="store_true")
    parser.add_argument("--gcs-address", default=None)
    parser.add_argument("--gcs-port", type=int, default=0)
    parser.add_argument("--resources", default=None)
    parser.add_argument("--store-capacity", type=int, default=512 * 1024 * 1024)
    parser.add_argument("--ready-file", required=True)
    parser.add_argument("--worker-env", default=None)
    parser.add_argument("--no-gpu-detect", action="store_true")
    parser.add_argument("--dashboard-port", type=int, default=0,
                        help="Head-node HTTP dashboard port (0 = ephemeral, "
                             "-1 = disabled)")
    parser.add_argument("--gcs-persist-path", default=None,
                        help="JSON snapshot file for GCS fault tolerance "
                             "(head only; reference: Redis-backed "
                             "gcs_table_storage)")
    parser.add_argument("--no-parent-watch", action="store_true",
                        help="Keep running after the launching process exits "
                             "(used by the `ray_tpu_torch start` CLI).")
    parser.add_argument("--labels", default=None,
                        help="JSON dict of node labels (e.g. autoscaler "
                             "node-type tags)")
    args = parser.parse_args()
    logging.basicConfig(level=os.environ.get("RT_LOG_LEVEL", "WARNING"))
    try:
        asyncio.run(amain(args, *node_resources(args)))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
