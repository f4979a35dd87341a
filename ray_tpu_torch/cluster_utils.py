"""Simulated multi-node cluster on one machine, for tests.

Design analog: reference ``python/ray/cluster_utils.py`` (Cluster:99,
add_node:165) -- the mechanism behind all of the reference's "multi-node"
tests: real GCS + per-node daemons as separate local processes, each with its
own worker pool, resource pool, and object store segment.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, info: dict):
        self.proc = proc
        self.info = info

    @property
    def node_id(self) -> str:
        return self.info["node_id"]

    @property
    def raylet_address(self) -> str:
        return self.info["raylet_address"]

    def kill(self):
        """Hard-kill the node daemon (and its worker subtree via parent-watch)."""
        self.proc.kill()
        self.proc.wait()


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.head_node: Optional[ClusterNode] = None
        self.worker_nodes: List[ClusterNode] = []
        self.gcs_address: Optional[str] = None
        self._head_args = dict(head_node_args or {})
        if initialize_head:
            self.head_node = self._start_node(head=True, **self._head_args)
            self.gcs_address = self.head_node.info["gcs_address"]

    @property
    def address(self) -> str:
        return self.gcs_address

    def _start_node(self, head: bool = False, num_cpus: int = 4,
                    resources: Optional[Dict[str, float]] = None,
                    object_store_memory: int = 256 * 1024 * 1024,
                    env: Optional[Dict[str, str]] = None,
                    labels: Optional[Dict[str, str]] = None,
                    gcs_persist_path: Optional[str] = None,
                    gcs_port: int = 0) -> ClusterNode:
        ready_file = os.path.join(
            tempfile.gettempdir(),
            f"rtt_node_{os.getpid()}_{uuid.uuid4().hex[:8]}.json")
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.daemon_main",
               "--ready-file", ready_file,
               "--resources", json.dumps(res),
               "--store-capacity", str(object_store_memory),
               "--no-gpu-detect"]
        if labels:
            cmd += ["--labels", json.dumps(labels)]
        if gcs_persist_path:
            cmd += ["--gcs-persist-path", gcs_persist_path]
        if head:
            cmd.append("--head")
            if gcs_port:
                # Fixed GCS port: a restarted head rebinds the same
                # address, so surviving worker raylets can redial it.
                cmd += ["--gcs-port", str(gcs_port)]
        else:
            cmd += ["--gcs-address", self.gcs_address]
        proc_env = dict(os.environ)
        proc_env.update(env or {})
        proc = subprocess.Popen(cmd, env=proc_env)
        deadline = time.monotonic() + 60
        while not os.path.exists(ready_file):
            if proc.poll() is not None:
                raise RuntimeError(f"node daemon exited rc={proc.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError("node daemon did not become ready")
            time.sleep(0.02)
        with open(ready_file) as f:
            info = json.load(f)
        os.unlink(ready_file)
        return ClusterNode(proc, info)

    def add_node(self, num_cpus: int = 4,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 256 * 1024 * 1024,
                 env: Optional[Dict[str, str]] = None,
                 labels: Optional[Dict[str, str]] = None) -> ClusterNode:
        node = self._start_node(head=False, num_cpus=num_cpus,
                                resources=resources,
                                object_store_memory=object_store_memory,
                                env=env, labels=labels)
        self.worker_nodes.append(node)
        return node

    def restart_head(self) -> ClusterNode:
        """Kill and restart the head daemon with its original args.

        Meaningful for GCS fault-tolerance tests when the head was
        started with an explicit ``gcs_port`` (same address after
        restart) and a ``gcs_persist_path`` (durable tables survive);
        surviving worker raylets then re-register over their
        reconnecting GCS connections without a daemon respawn."""
        assert self.head_node is not None, "cluster has no head"
        self.head_node.kill()
        self.head_node = self._start_node(head=True, **self._head_args)
        self.gcs_address = self.head_node.info["gcs_address"]
        return self.head_node

    def remove_node(self, node: ClusterNode):
        node.kill()
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def wait_for_nodes(self, timeout: float = 30.0) -> int:
        """Block until all started nodes are registered & alive in the GCS."""
        import ray_tpu_torch
        expected = 1 + len(self.worker_nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
                if len(alive) >= expected:
                    return len(alive)
            except Exception:
                pass
            time.sleep(0.1)
        raise TimeoutError(f"expected {expected} alive nodes")

    def shutdown(self):
        for node in self.worker_nodes:
            node.kill()
        self.worker_nodes.clear()
        if self.head_node is not None:
            self.head_node.kill()
            self.head_node = None
