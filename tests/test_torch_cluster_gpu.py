"""The cluster layer and tools on the card.

* A head started by the CLI advertises the card its daemon finds (``GPU``
  and an ``accelerator_type:``); a submitted job's entrypoint sees no card
  (``torch.cuda.is_available()`` is False in its process) while the
  ``num_gpus=1`` actor it creates computes on the card.
* Through the client proxy, a ``num_gpus=1`` actor's CUDA tensor reaches
  the client as a CPU tensor with the same bytes: the session holds no
  card.
* A queued ``num_gpus=1`` actor makes the autoscaler launch a node given
  the card; the actor computes there, and the idle node is ended.
* chip_smoke.py's runtime_cluster step: the same paths with GPT-2-small's
  flash forward (see chip_smoke.py).

The tests need a CUDA card and skip without one.  This module imports
nothing of JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cluster_gpu.py
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                      Monitor, NodeTypeConfig)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.client import connect, start_proxy

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_cluster_gpu.py`")


def _on_card():
    """A num_gpus=1 actor class: a seeded product on its card.  Made in a
    function, so it travels by value to sessions and workers that cannot
    import this module."""

    class OnCard:
        def product(self, n=256):
            import torch
            g = torch.Generator(device="cuda").manual_seed(0)
            a = torch.randn((n, n), device="cuda", generator=g)
            return a @ a

        def sees_card(self):
            import torch
            return torch.cuda.is_available()

    return OnCard


ENTRYPOINT = '''
import torch
import ray_tpu_torch as rt
rt.init()
assert not torch.cuda.is_available(), "the entrypoint sees a card"

@rt.remote(num_gpus=1)
class OnCard:
    def product(self):
        import torch
        a = torch.ones((256, 256), device="cuda")
        return a @ a

    def sees_card(self):
        import torch
        return torch.cuda.is_available()

a = OnCard.remote()
t = rt.get(a.product.remote())
print("DEVICE", t.device.type, "CARD", rt.get(a.sees_card.remote()))
rt.kill(a)
'''


def test_cli_head_job_entrypoint_holds_no_card(tmp_path):
    env = dict(os.environ, RT_SESSION_DIR=str(tmp_path / "session"))

    def cli(*argv, timeout=300):
        r = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch"] + list(argv), env=env,
            capture_output=True, text=True, timeout=timeout, cwd=ROOT)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    cli("start", "--head", "--num-cpus", "2", "--port", "0",
        "--dashboard-port", "-1")
    try:
        total = json.loads(cli("status"))["resources"]["total"]
        assert total.get("GPU", 0) >= 1
        assert [k for k in total if k.startswith("accelerator_type:")]
        entry = tmp_path / "entry.py"
        entry.write_text(ENTRYPOINT)
        out = cli("job", "submit", "--wait", "--", sys.executable,
                  str(entry))
        # the actor's result lands on the CPU: the entrypoint has no card
        assert "DEVICE cpu CARD True" in out, out
    finally:
        cli("stop")


def test_client_gets_a_gpu_actors_tensor_on_the_cpu():
    info = ray_tpu_torch.init(num_cpus=2)
    proxy, address = start_proxy(info["gcs_address"])
    c = connect(address)
    try:
        on_card = _on_card()
        a = c.remote(num_gpus=1)(on_card).remote()
        t = c.get(a.product.remote())
        assert t.device.type == "cpu"
        assert torch.equal(t, on_card().product().cpu())
        c.kill(a)
    finally:
        c.disconnect(end_session=True)
        ray_tpu_torch.shutdown()


def test_autoscaled_gpu_node_runs_on_the_card():
    cluster = Cluster(head_node_args={
        "num_cpus": 1, "env": {"RT_NODE_RECONNECT_GRACE_S": "2"}})
    monitor = None
    try:
        ray_tpu_torch.init(address=cluster.address)
        provider = LocalNodeProvider(cluster)
        cfg = AutoscalerConfig(
            node_types=[NodeTypeConfig("gpu1", {"CPU": 2.0, "GPU": 1.0},
                                       max_workers=1)],
            idle_timeout_s=2.0)
        monitor = Monitor(provider, cfg, update_interval_s=0.5).start()
        a = ray_tpu_torch.remote(_on_card()).options(num_gpus=1).remote()
        assert ray_tpu_torch.get(a.sees_card.remote(), timeout=300)
        ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 60
        while provider.non_terminated_nodes():
            assert time.monotonic() < deadline, "the idle node lives on"
            time.sleep(0.2)
    finally:
        if monitor:
            monitor.stop()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
