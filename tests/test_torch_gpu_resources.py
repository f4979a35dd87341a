"""GPUs as a resource in the port's runtime, with fake cards.

A node started with ``RT_NUM_GPUS=4`` advertises four cards with no card
present.  A worker leased ``num_gpus=k`` must see k ids of its own in
``CUDA_VISIBLE_DEVICES`` and no two live leases may share one; a worker
without a lease sees ``""``; a GPU request on a cluster without cards
stays pending.  The purity test holds that no process of a cluster (the
daemon, the forkserver template, a forked and a cold worker) imports JAX
or anything of ``ray_tpu``.  This module imports neither: the cluster's
workers import it.
"""

import os
import re
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                placement_group, remove_placement_group)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gpu_cluster():
    old = os.environ.get("RT_NUM_GPUS")
    os.environ["RT_NUM_GPUS"] = "4"
    try:
        ray_tpu_torch.init(num_cpus=8)
    finally:
        if old is None:
            del os.environ["RT_NUM_GPUS"]
        else:
            os.environ["RT_NUM_GPUS"] = old
    yield
    ray_tpu_torch.shutdown()


def _visible():
    return os.environ["CUDA_VISIBLE_DEVICES"]


@ray_tpu_torch.remote(num_gpus=1)
class GpuActor:
    def visible(self):
        return _visible()


@ray_tpu_torch.remote
class CpuActor:
    def visible(self):
        return _visible()


@ray_tpu_torch.remote
def cpu_task():
    return _visible()


@ray_tpu_torch.remote(num_gpus=2)
def two_card_task():
    return _visible()


def test_node_advertises_the_fake_cards(gpu_cluster):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 4.0


def test_four_gpu_actors_see_distinct_cards_and_a_fifth_waits(gpu_cluster):
    actors = [GpuActor.remote() for _ in range(4)]
    seen = ray_tpu_torch.get([a.visible.remote() for a in actors],
                             timeout=120)
    assert sorted(seen) == ["0", "1", "2", "3"]
    fifth = GpuActor.remote()
    ref = fifth.visible.remote()
    ready, _ = ray_tpu_torch.wait([ref], timeout=2)
    assert ready == []
    ray_tpu_torch.kill(actors[1])
    assert ray_tpu_torch.get(ref, timeout=120) == seen[1]
    for a in actors[:1] + actors[2:] + [fifth]:
        ray_tpu_torch.kill(a)


def test_actor_placed_before_the_reap_waits_for_the_card(gpu_cluster):
    """The GCS frees a killed actor's card when it asks for the kill and
    may place the next GPU actor at once; the raylet frees the card's id
    only when it reaps the old process.  The new actor waits for the
    reap instead of failing its creation (serve's scale-down and delete
    hit this: a replacement replica is created right after the kill)."""
    actors = [GpuActor.remote() for _ in range(4)]
    seen = ray_tpu_torch.get([a.visible.remote() for a in actors],
                             timeout=120)
    for round_ in range(3):
        ray_tpu_torch.kill(actors[round_])
        actors[round_] = GpuActor.remote()
        assert ray_tpu_torch.get(actors[round_].visible.remote(),
                                 timeout=120) == seen[round_]
    for a in actors:
        ray_tpu_torch.kill(a)


@ray_tpu_torch.remote
def resolve_default_device():
    return str(ray_tpu_torch.resolve_device())


@ray_tpu_torch.remote(num_gpus=1)
class ModelOnTheCard:
    def __init__(self):
        self.device = ray_tpu_torch.resolve_device()

    def where(self):
        return str(self.device)


def test_workers_without_a_lease_see_no_card(gpu_cluster):
    assert ray_tpu_torch.get(cpu_task.remote(), timeout=60) == ""
    a = CpuActor.remote()
    assert ray_tpu_torch.get(a.visible.remote(), timeout=60) == ""
    ray_tpu_torch.kill(a)
    # The compute entry points keep their rule inside a worker: without a
    # card they raise, they never run on the CPU unasked.
    with pytest.raises(Exception, match="CUDA"):
        ray_tpu_torch.get(resolve_default_device.remote(), timeout=60)


def test_gpu_actor_that_lands_without_a_card_raises(gpu_cluster):
    """The fake cards name no real one: a GPU actor's model refuses to
    start instead of running on the CPU."""
    a = ModelOnTheCard.remote()
    with pytest.raises(Exception, match="CUDA"):
        ray_tpu_torch.get(a.where.remote(), timeout=120)


def test_gpu_tasks_take_whole_cards_of_their_own(gpu_cluster):
    import time
    deadline = time.monotonic() + 60
    while ray_tpu_torch.available_resources().get("GPU") != 4.0:
        assert time.monotonic() < deadline, "cards never came back"
        time.sleep(0.1)
    ids = ray_tpu_torch.get([two_card_task.remote(), two_card_task.remote()],
                            timeout=120)
    assert all(len(v.split(",")) == 2 for v in ids)
    with pytest.raises(ValueError, match="whole number"):
        cpu_task.options(num_gpus=0.5).remote()


def test_placement_group_gpu_bundles_give_distinct_cards(gpu_cluster):
    pg = placement_group([{"GPU": 1}, {"GPU": 1}], strategy="PACK")
    assert pg.ready(timeout=60)
    actors = [GpuActor.options(
        num_cpus=0, scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(2)]
    seen = ray_tpu_torch.get([a.visible.remote() for a in actors],
                             timeout=120)
    assert len(set(seen)) == 2 and all(s in "0123" for s in seen)
    for a in actors:
        ray_tpu_torch.kill(a)
    remove_placement_group(pg)


def _hermetic_env():
    """The pytest process's environment without the runtime's switches
    (``RT_*``) and the card mask: an earlier test file in the same xdist
    worker may have left them set (``RT_DISABLE_FORKSERVER=1`` starts a
    cluster without its fork template), and a driver must see only what
    its test gives it."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith("RT_") and k != "CUDA_VISIBLE_DEVICES"}


def _driver(code, env, timeout=120):
    env = dict(_hermetic_env(), PYTHONPATH=ROOT, **env)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_gpu_task_without_cards_never_runs(tmp_path):
    marker = tmp_path / "ran"
    code = f"""
import ray_tpu_torch as rt
rt.init(num_cpus=2)
assert "GPU" not in rt.cluster_resources()

@rt.remote(num_gpus=1)
def needs_card():
    open({str(marker)!r}, "w").close()

ready, pending = rt.wait([needs_card.remote()], timeout=3)
print("READY", len(ready), len(pending))
rt.shutdown()
"""
    out = _driver(code, {"RT_NUM_GPUS": "0"}).stdout
    assert "READY 0 1" in out
    assert not marker.exists()


_FORBIDDEN_IMPORT = re.compile(r"\|\s*(jax|jaxlib|ray_tpu)(\.\S*)?\s*$")


def _imports(text):
    return [ln.rsplit("|", 1)[1].strip() for ln in text.splitlines()
            if ln.startswith("import time:") and "|" in ln]


def test_no_process_of_a_cluster_imports_jax_or_ray_tpu(tmp_path):
    code = """
import os
import ray_tpu_torch as rt
rt.init(num_cpus=2)

@rt.remote
def forked():
    return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

@rt.remote(num_gpus=1)
def cold():
    return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

print("RESULT", rt.get(forked.remote()), rt.get(cold.remote()))
rt.shutdown()
"""
    proc = _driver(code, {"RT_NUM_GPUS": "1", "PYTHONPROFILEIMPORTTIME": "1",
                          "RT_LOG_DIR": str(tmp_path)})
    assert re.search(r"RESULT \('', \d+\) \('0', \d+\)", proc.stdout)
    logs = {p.name: p.read_text() for p in tmp_path.iterdir()
            if p.suffix in (".err", ".log")}
    template = logs.get("forkserver.log", "")
    assert "forkserver ready" in template
    workers = [v for k, v in logs.items() if k.startswith("worker-")]
    # A forked worker inherits the runtime's modules from the template and
    # imports none of them itself; the cold (GPU) worker imports them all.
    own = ["ray_tpu_torch._private.core_worker" in _imports(t)
           for t in workers]
    assert sorted(own) == [False, True], own
    # The driver's stderr carries the daemon's (it inherits it).
    for name, text in [("driver+daemon", proc.stderr),
                       ("template", template)] + [
                           (f"worker{i}", t) for i, t in enumerate(workers)]:
        mods = _imports(text)
        bad = [m for m in mods if _FORBIDDEN_IMPORT.search("| " + m)]
        assert not bad, (name, bad)
    # Only the daemon imports the raylet.
    assert "ray_tpu_torch._private.raylet" in _imports(proc.stderr)
    assert "ray_tpu_torch._private.worker_main" in _imports(template)
    assert "torch" not in _imports(template)


def test_detection_order(monkeypatch, tmp_path):
    from ray_tpu_torch._private import gpu_topology as topo
    monkeypatch.setattr(topo, "_INFO_GLOB", str(tmp_path / "*" / "info"))
    monkeypatch.setattr(topo, "_nvidia_smi", lambda: [
        ("0", "NVIDIA H100 80GB HBM3"), ("1", "NVIDIA H100 80GB HBM3")])
    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert topo.detect() == (["0", "1"], {"GPU": 2.0,
                                          "accelerator_type:H100": 1.0})
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert topo.detect() == (["3"], {"GPU": 1.0,
                                     "accelerator_type:H100": 1.0})
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert topo.detect() == ([], {})
    (tmp_path / "0000").mkdir()
    (tmp_path / "0000" / "info").write_text(
        "Model: \t\t NVIDIA A100-SXM4-80GB\nIRQ: 1\n")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert topo.detect()[1]["accelerator_type:A100-SXM4-80GB"] == 1.0
    monkeypatch.setenv("RT_NUM_GPUS", "3")
    assert topo.detect() == (["0", "1", "2"], {"GPU": 3.0})
