"""The cluster layer and tools with the card as a resource, with a fake
card (``RT_NUM_GPUS``, no card present).

* A CLI-started head advertises the card its daemon finds; a job's
  entrypoint sees ``CUDA_VISIBLE_DEVICES=""`` (also when the job's
  ``env_vars`` name a card), while a ``num_gpus=1`` actor it creates is
  leased the card.  A job that holds the card through an actor and kills
  it on SIGTERM gives the card back on ``job stop``: actors outlive the
  driver that made them (the GCS records no owner for an actor), so the
  entrypoint ends its own.
* A queued ``num_gpus=1`` actor makes the autoscaler launch a node of a
  ``GPU`` node type, the actor is leased that node's card, and the node is
  ended after its idle timeout once the actor is gone.
* A client session holds no card (its ``CUDA_VISIBLE_DEVICES`` is ``""``)
  while the ``num_gpus=1`` actor it creates holds one, and the card comes
  back once the client kills the actor and ends the session.
* A breakpoint in a ``num_gpus=1`` actor: rpdb attaches, reads the
  actor's card and continues it.

This module imports nothing of JAX: the cluster's workers import it.
"""

import io
import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                      Monitor, NodeTypeConfig)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job import JobStatus, JobSubmissionClient
from ray_tpu_torch.util import rpdb
from ray_tpu_torch.util.client import connect, start_proxy


@pytest.fixture
def fake_card(monkeypatch):
    """One fake card, found by the head's daemon (which inherits the
    environment)."""
    monkeypatch.setenv("RT_NUM_GPUS", "1")
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _wait(cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def _card_free():
    return ray_tpu_torch.available_resources().get("GPU") == 1.0


# The entrypoint of the card-holding jobs: its own visibility, then a
# num_gpus=1 actor's; with --hold it keeps the actor until SIGTERM, which
# kills the actor and exits.
ENTRYPOINT = '''
import os, signal, sys, time
import ray_tpu_torch as rt
rt.init()
print("ENTRY", repr(os.environ.get("CUDA_VISIBLE_DEVICES")), flush=True)

@rt.remote(num_gpus=1)
class Holder:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

h = Holder.remote()
print("ACTOR", repr(rt.get(h.visible.remote(), timeout=120)), flush=True)
if "--hold" in sys.argv:
    def stop(*_):
        rt.kill(h)
        print("RELEASED", flush=True)
        sys.exit(0)
    signal.signal(signal.SIGTERM, stop)
    while True:
        time.sleep(1)
'''


def _entrypoint(tmp_path):
    path = tmp_path / "entry.py"
    path.write_text(ENTRYPOINT)
    return str(path)


def test_cli_head_advertises_the_card_and_a_job_entrypoint_sees_none(
        tmp_path):
    env = dict(os.environ, RT_SESSION_DIR=str(tmp_path / "session"),
               RT_NUM_GPUS="1")

    def cli(*argv, timeout=180):
        r = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch"] + list(argv),
            env=env, capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    cli("start", "--head", "--num-cpus", "2", "--port", "0",
        "--dashboard-port", "-1")
    try:
        summary = json.loads(cli("status"))
        assert summary["resources"]["total"]["GPU"] == 1.0
        out = cli("job", "submit", "--wait", "--runtime-env-json",
                  json.dumps({"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}}),
                  "--", sys.executable, _entrypoint(tmp_path))
        assert "ENTRY ''" in out and "ACTOR '0'" in out, out
    finally:
        cli("stop")


def test_job_stop_gives_the_card_back(fake_card, tmp_path):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} {_entrypoint(tmp_path)} --hold")
    _wait(lambda: "ACTOR '0'" in client.get_job_logs(sid),
          "the job's actor never got the card", timeout=120)
    assert "ENTRY ''" in client.get_job_logs(sid)
    assert not _card_free()
    assert client.stop_job(sid)
    assert client.wait_until_finished(sid, timeout=60) == JobStatus.STOPPED
    assert "RELEASED" in client.get_job_logs(sid)
    _wait(_card_free, "the card never came back")


def test_queued_gpu_actor_scales_a_gpu_node_up_and_its_idle_node_down():
    # A short reconnect grace: the ended node leaves the GCS's view soon.
    cluster = Cluster(head_node_args={
        "num_cpus": 1, "env": {"RT_NODE_RECONNECT_GRACE_S": "2"}})
    monitor = None
    try:
        ray_tpu_torch.init(address=cluster.address)
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
        provider = LocalNodeProvider(cluster)
        cfg = AutoscalerConfig(
            node_types=[NodeTypeConfig("gpu1", {"CPU": 4.0, "GPU": 1.0},
                                       min_workers=0, max_workers=1)],
            idle_timeout_s=2.0)
        monitor = Monitor(provider, cfg, update_interval_s=0.5).start()

        @ray_tpu_torch.remote(num_gpus=1)
        class OnCard:
            def where(self):
                return (os.environ.get("RT_NODE_ID"),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        a = OnCard.remote()   # no node has a card: queued -> scale up
        node_id, visible = ray_tpu_torch.get(a.where.remote(), timeout=120)
        assert node_id != cluster.head_node.node_id and visible == "0"
        _wait(lambda: len(provider.non_terminated_nodes()) == 1,
              "the provider never recorded its node")
        assert provider.non_terminated_nodes()[0].node_type == "gpu1"
        ray_tpu_torch.kill(a)
        _wait(lambda: provider.non_terminated_nodes() == [],
              "the idle GPU node was never ended", timeout=60)
        _wait(lambda: ray_tpu_torch.cluster_resources().get("GPU", 0) == 0,
              "the ended node's card is still advertised")
    finally:
        if monitor:
            monitor.stop()
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        pairs = [kv.split(b"=", 1) for kv in f.read().split(b"\0") if kv]
    return {k.decode(): v.decode() for k, v in pairs}


def test_client_session_holds_no_card(fake_card):
    info = ray_tpu_torch.init()
    proxy, address = start_proxy(info["gcs_address"])
    c = connect(address)
    try:
        pid = c.ping()["pid"]
        assert _environ(pid)["CUDA_VISIBLE_DEVICES"] == ""

        @c.remote(num_gpus=1)
        class OnCard:
            def visible(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES")

        a = OnCard.remote()
        assert c.get(a.visible.remote()) == "0"
        assert not _card_free()
        c.kill(a)
    finally:
        c.disconnect(end_session=True)
    _wait(lambda: not os.path.exists(f"/proc/{pid}") or
          open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0]
          in ("Z", "X"), "the session outlived end_session")
    _wait(_card_free, "the card never came back")
    assert proxy.sessions == {}


def _gpu_breakpoint():
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ray_tpu_torch.util.rpdb.set_trace(timeout_s=30)
    return visible


def test_breakpoint_in_a_gpu_actor(fake_card):
    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def run(self):
            return _gpu_breakpoint()

    a = OnCard.remote()
    ref = a.run.remote()
    _wait(lambda: rpdb.list_sessions(), "no breakpoint registered",
          timeout=120)
    s = rpdb.list_sessions()[0]
    assert s["function"] == "_gpu_breakpoint"
    out = io.StringIO()
    rpdb.connect(s, stdin=io.StringIO("p visible\nc\n"), stdout=out)
    assert "'0'" in out.getvalue(), out.getvalue()
    assert ray_tpu_torch.get(ref, timeout=30) == "0"
    ray_tpu_torch.kill(a)
    _wait(_card_free, "the card never came back")
