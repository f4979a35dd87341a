"""Release benchmark: 1->N object distribution, broadcast vs pull storm.

Port of ``ray_tpu/_private/broadcast_bench.py``.

Counterpart of BASELINE.md's "1 GiB broadcast to 50 nodes" reference
number (release/nightly_tests/many_nodes_tests): a large driver-put object
must reach every node.  Two strategies measured on a simulated N-node
cluster:

  * pull storm  — every node issues pull_object against the single holder
    (the reference's only mechanism; its pull manager just dedups).
  * tree broadcast — binomial push fan-out (ray_tpu_torch.util.broadcast):
    each link carries the object once, relays push in parallel.

Emits one JSON line per metric on stdout (release-harness format).

Usage: python -m ray_tpu_torch._private.broadcast_bench [--size-mb 256]
       [--nodes 8] [--quick]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--quick", action="store_true",
                    help="16MB x 4 nodes smoke variant")
    args = ap.parse_args()
    if args.quick:
        args.size_mb, args.nodes = 16, 4

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private.protocol import connect
    from ray_tpu_torch.cluster_utils import Cluster

    store_cap = max(512 * 1024 * 1024, 4 * args.size_mb * 1024 * 1024)
    c = Cluster(head_node_args={"num_cpus": 1,
                                "object_store_memory": store_cap})
    for i in range(args.nodes):
        c.add_node(num_cpus=1, resources={f"n{i}": 1.0},
                   object_store_memory=store_cap)
    ray_tpu_torch.init(address=c.address)
    c.wait_for_nodes()
    addrs = [n.raylet_address for n in c.worker_nodes]
    _log(f"bcast bench: {args.nodes} nodes up, object {args.size_mb}MB")

    payload = np.random.default_rng(0).bytes(args.size_mb * 1024 * 1024)

    async def _pull_storm(oid_hex):
        conns = [await connect(a, None, name="bench") for a in addrs]
        t0 = time.perf_counter()
        rs = await asyncio.gather(*(
            conn.request({"type": "pull_object", "object_id": oid_hex},
                         timeout=600) for conn in conns))
        dt = time.perf_counter() - t0
        for conn in conns:
            await conn.close()
        assert all(r.get("ok") for r in rs), rs
        return dt

    # -- pull storm on a fresh object
    ref1 = ray_tpu_torch.put(payload)
    t_pull = asyncio.run(_pull_storm(ref1.id.hex()))
    _log(f"pull storm: {t_pull:.2f}s")

    # -- tree broadcast on a second fresh object
    ref2 = ray_tpu_torch.put(payload)
    t0 = time.perf_counter()
    n = ray_tpu_torch.util.broadcast(ref2, timeout=600)
    t_bcast = time.perf_counter() - t0
    assert n == args.nodes, (n, args.nodes)
    _log(f"tree broadcast: {t_bcast:.2f}s")

    gbps = args.size_mb * args.nodes / 1024 / t_bcast
    for m in (
        {"metric": "pull_storm_s", "value": round(t_pull, 3), "unit": "s",
         "nodes": args.nodes, "size_mb": args.size_mb},
        {"metric": "broadcast_s", "value": round(t_bcast, 3), "unit": "s",
         "nodes": args.nodes, "size_mb": args.size_mb},
        {"metric": "broadcast_speedup_vs_pull",
         "value": round(t_pull / t_bcast, 3), "unit": "x"},
        {"metric": "broadcast_agg_gbps", "value": round(gbps, 3),
         "unit": "GiB/s"},
    ):
        print(json.dumps(m), flush=True)

    ray_tpu_torch.shutdown()
    c.shutdown()


if __name__ == "__main__":
    main()
