"""Global driver/worker singleton and cluster bring-up.

Design analog: reference ``python/ray/_private/worker.py`` (Worker singleton,
init/shutdown/connect) + ``_private/node.py`` (process spawning).
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.core_worker import CoreWorker


class Worker:
    def __init__(self):
        self.core_worker: Optional[CoreWorker] = None
        self.mode: Optional[str] = None  # "driver" | "worker"
        self.namespace: str = "default"
        self._daemon_proc: Optional[subprocess.Popen] = None
        self._ready_info: Optional[dict] = None
        self.job_id: Optional[str] = None

    @property
    def connected(self) -> bool:
        return self.core_worker is not None

    def attach_core(self, core: CoreWorker, mode: str):
        self.core_worker = core
        self.mode = mode

    # ------------------------------------------------------------ init

    def init(
        self,
        address: Optional[str] = None,
        *,
        num_cpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        namespace: Optional[str] = None,
        object_store_memory: Optional[int] = None,
        log_level: str = "WARNING",
        log_to_driver: bool = True,
        local_mode: bool = False,
        _worker_env: Optional[Dict[str, str]] = None,
        _system_config: Optional[Dict[str, Any]] = None,
    ):
        if self.connected:
            return self.connection_info()
        if local_mode:
            # Inline debugging mode (reference: ray.init(local_mode=True)):
            # no daemons; tasks/actors run synchronously in this process.
            from ray_tpu_torch._private.local_mode import LocalModeCore
            core = LocalModeCore()
            self.attach_core(core, mode="local")
            self.namespace = namespace or "default"
            self.job_id = "local"
            self._ready_info = core.connection_info()
            return self.connection_info()
        # Config overrides (reference: ray.init(_system_config=...)): apply
        # to this process and export so daemons/workers inherit the view.
        from ray_tpu_torch._private.config import apply_system_config
        apply_system_config(_system_config)
        self.namespace = namespace or "default"
        # Same-machine workers must be able to import the driver's modules
        # (reference: workers inherit the driver's environment on a local
        # cluster; multi-node code shipping is runtime_env working_dir).
        _worker_env = dict(_worker_env or {})
        _worker_env.setdefault(
            "RT_DRIVER_SYS_PATH",
            os.pathsep.join(p or os.getcwd() for p in sys.path))
        if address is None:
            # Reference parity: RAY_ADDRESS -> RT_ADDRESS lets `job submit`
            # drivers and CLI tools connect without code changes.
            address = os.environ.get("RT_ADDRESS") or None
        # Ray Client mode (reference: ray://host:port remote drivers via
        # util/client/): the driver talks to the cluster purely over TCP —
        # GCS + a remote raylet + owner-served object bytes — with no
        # local shared-memory attach, so it can run on any machine that
        # reaches the head.  Every runtime path already degrades cleanly
        # when plasma is absent (inline owner store + owner get_object).
        client_mode = False
        if address and address.startswith("ray://"):
            address = address[len("ray://"):]
            client_mode = True
        if address is None:
            self._start_local_cluster(num_cpus, resources, object_store_memory,
                                      log_level, _worker_env)
            info = self._ready_info
            gcs_address = info["gcs_address"]
        else:
            # address is the GCS address of a running cluster; discover the
            # local node's raylet through it.
            gcs_address = address
            info = self._discover_node(gcs_address)
        self.job_id = uuid.uuid4().hex[:12]
        core = CoreWorker(
            gcs_address=gcs_address,
            raylet_address=info["raylet_address"],
            store_name=None if client_mode else info["store_name"],
            node_id_hex=info["node_id"],
            job_id=self.job_id,
        )
        self.core_worker = core
        self.mode = "driver"
        core.gcs_request({"type": "register_job", "job_id": self.job_id,
                          "driver_address": core.address})
        if log_to_driver:
            # Echo worker stdout/stderr on this console, filtered to this
            # job (reference: ray_logging.print_logs' job_id filter).
            # Untagged batches (idle workers, nested-task workers) pass.
            from ray_tpu_torch._private.log_monitor import print_to_driver
            my_job = self.job_id

            def _echo(batch, _job=my_job):
                if batch.get("job_id") in (None, _job):
                    print_to_driver(batch)

            core.subscribe("worker_logs", _echo)
        atexit.register(self.shutdown)
        return self.connection_info()

    def _start_local_cluster(self, num_cpus, resources, object_store_memory,
                             log_level, worker_env):
        ready_file = os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_head_{os.getpid()}_{uuid.uuid4().hex[:6]}.json")
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.daemon_main",
            "--head", "--ready-file", ready_file,
        ]
        if res:
            cmd += ["--resources", json.dumps(res)]
        if object_store_memory:
            cmd += ["--store-capacity", str(object_store_memory)]
        if worker_env:
            cmd += ["--worker-env", json.dumps(worker_env)]
        env = dict(os.environ)
        env["RT_LOG_LEVEL"] = log_level
        self._daemon_proc = subprocess.Popen(cmd, env=env)
        deadline = time.monotonic() + 60
        while not os.path.exists(ready_file):
            if self._daemon_proc.poll() is not None:
                raise RuntimeError(
                    f"head daemon exited with code {self._daemon_proc.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError("timed out waiting for head daemon")
            time.sleep(0.02)
        with open(ready_file) as f:
            self._ready_info = json.load(f)
        os.unlink(ready_file)

    def _discover_node(self, gcs_address: str) -> dict:
        """Connect to GCS and pick this host's (or the head) node."""
        import asyncio

        from ray_tpu_torch._private.protocol import connect

        async def go():
            async def noop(msg):
                return None
            conn = await connect(gcs_address, noop)
            nodes = await conn.request({"type": "get_nodes"})
            await conn.close()
            return nodes

        nodes = asyncio.run(go())
        alive = [n for n in nodes if n["alive"]]
        head = [n for n in alive if n.get("is_head")] or alive
        n = head[0]
        return {"raylet_address": n["address"], "store_name": n["store_name"],
                "node_id": n["node_id"], "gcs_address": gcs_address}

    def connection_info(self) -> dict:
        info = dict(self._ready_info or {})
        info["job_id"] = self.job_id
        return info

    # ------------------------------------------------------------ shutdown

    def shutdown(self):
        try:
            atexit.unregister(self.shutdown)
        except Exception:
            pass
        if self.core_worker is not None and self.mode == "local":
            self.core_worker.shutdown()
            self.core_worker = None
            self._ready_info = None
            return
        if self.core_worker is not None and self.mode == "driver":
            # Local-only usage snapshot (reference usage_lib, minus the
            # phone-home: this environment has no egress by design).
            from ray_tpu_torch._private.usage_stats import write_report_at_shutdown
            write_report_at_shutdown()
        if self.core_worker is not None:
            try:
                self.core_worker.gcs_request({"type": "finish_job",
                                              "job_id": self.job_id})
            except Exception:
                pass
            self.core_worker.shutdown()
            self.core_worker = None
        if self._daemon_proc is not None:
            try:
                self._daemon_proc.terminate()
                self._daemon_proc.wait(timeout=5)
            except Exception:
                try:
                    self._daemon_proc.kill()
                except Exception:
                    pass
            self._daemon_proc = None
        self._ready_info = None
        self.mode = None


global_worker = Worker()


def get_core() -> CoreWorker:
    if global_worker.core_worker is None:
        raise RuntimeError(
            "ray_tpu_torch.init() must be called before using the API")
    return global_worker.core_worker


def auto_init():
    if global_worker.core_worker is None:
        global_worker.init()
