"""Head-node crash recovery end to end: a Serve app survives a full
head restart.

Reference shape: test_gcs_fault_tolerance.py head-restart cases + serve
controller recovery.  Chain under test: GCS snapshot persists the
detached controller's record -> the restarted head replays its creation
when the node re-registers -> the controller's _maybe_restore loads its
KV state (snapshot-durable) -> reconcile finds the old replicas dead and
replaces them -> requests serve again.

The port's runtime under ``test_head_restart_serve.py``'s case: the head
is started and stopped through the port's CLI (``python -m ray_tpu_torch
start/stop``, a private ``RT_SESSION_DIR``), killed with SIGKILL and
started again on the session's GCS snapshot; the drivers are separate
processes, as the reference's are.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_serve_survives_head_crash(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT,
           "RT_SESSION_DIR": str(tmp_path / "session")}

    def cli(*args, timeout=120):
        r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    def run_driver(script, timeout=240):
        # Target the CLI daemon cluster explicitly: init() without an
        # address would bootstrap a private in-process cluster.
        sess = json.loads(
            (tmp_path / "session" / "cluster.json").read_text())
        denv = {**env, "RT_ADDRESS": sess["gcs_address"]}
        return subprocess.run([sys.executable, "-c", script], env=denv,
                              capture_output=True, text=True,
                              timeout=timeout)

    cli("start", "--head", "--port", "0")
    try:
        r = run_driver("""
import ray_tpu_torch
from ray_tpu_torch import serve
ray_tpu_torch.init()

@serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.1})
def double(x):
    return 2 * x

h = serve.run(double.bind())
assert ray_tpu_torch.get(h.remote(21)) == 42
print("DEPLOYED_OK")
""")
        assert "DEPLOYED_OK" in r.stdout, r.stdout + r.stderr

        # Wait for the GCS snapshot to flush the serve state (period
        # 1s): the durability contract is crash-AFTER-flush recovers;
        # a crash inside the final snapshot window may lose that second.
        snap = tmp_path / "session" / "gcs_snapshot.json"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not snap.exists():
            time.sleep(0.2)
        assert snap.exists(), "GCS snapshot never flushed"
        time.sleep(2.0)   # one more period: serve KV state included

        # Crash the head daemon (SIGKILL: no graceful teardown, snapshot
        # stays on disk).
        sess = json.loads(
            (tmp_path / "session" / "cluster.json").read_text())
        for node in sess["nodes"]:
            os.kill(node["pid"], signal.SIGKILL)
        time.sleep(1.0)
        # A clean session file so `start --head` records the new node; the
        # GCS snapshot file survives (crash semantics).
        (tmp_path / "session" / "cluster.json").write_text(
            json.dumps({"nodes": []}))

        cli("start", "--head", "--port", "0")

        r = run_driver("""
import time
import ray_tpu_torch
from ray_tpu_torch import serve
ray_tpu_torch.init()
deadline = time.monotonic() + 120
last = None
while time.monotonic() < deadline:
    try:
        h = serve.get_handle("double")
        assert ray_tpu_torch.get(h.remote(5), timeout=30) == 10
        print("RECOVERED_OK")
        break
    except Exception as e:
        last = e
        time.sleep(1.0)
else:
    raise SystemExit(f"serve did not recover: {last!r}")
""")
        assert "RECOVERED_OK" in r.stdout, r.stdout + r.stderr
    finally:
        subprocess.run([sys.executable, "-m", "ray_tpu_torch", "stop"],
                       env=env, capture_output=True, timeout=60)
