"""DAG building/execution + durable workflow run/resume.

Reference analogs: python/ray/dag/tests/test_function_dag.py and
python/ray/workflow/tests/test_basic_workflows.py (resume skips completed
steps; exactly-once side effects).

The port's runtime under ``test_workflow_dag.py``'s cases, one for one.
"""

import os
import uuid

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture(scope="module")
def wf_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture()
def wf_storage(tmp_path):
    workflow.init(str(tmp_path / "wf"))
    yield


@ray_tpu_torch.remote
def _add(a, b):
    return a + b


@ray_tpu_torch.remote
def _mul(a, b):
    return a * b


def test_dag_bind_and_execute(wf_cluster):
    with InputNode() as x:
        dag = _add.bind(_mul.bind(x, 2), _mul.bind(x, 3))
    ref = dag.execute(10)
    assert ray_tpu_torch.get(ref) == 50  # 10*2 + 10*3
    # Diamond sharing: the shared node runs once per execute, its handle
    # reused by both parents.
    with InputNode() as x:
        shared = _mul.bind(x, 2)
        diamond = _add.bind(shared, shared)
    assert ray_tpu_torch.get(diamond.execute(7)) == 28


def test_dag_multi_output(wf_cluster):
    with InputNode() as x:
        dag = MultiOutputNode([_mul.bind(x, 2), _mul.bind(x, 5)])
    refs = dag.execute(3)
    assert ray_tpu_torch.get(refs) == [6, 15]


def test_workflow_run_and_status(wf_cluster, wf_storage):
    with InputNode() as x:
        dag = _add.bind(_mul.bind(x, 2), 1)
    wid = f"w_{uuid.uuid4().hex[:6]}"
    assert workflow.run(dag, workflow_id=wid, args=(5,)) == 11
    assert workflow.get_status(wid) == "SUCCEEDED"
    assert workflow.get_output(wid) == 11
    assert any(w["workflow_id"] == wid for w in workflow.list_all())


def test_workflow_resume_skips_completed_steps(wf_cluster, wf_storage,
                                               tmp_path):
    """A step that fails leaves earlier steps checkpointed; resume re-runs
    only the failed step onward (exactly-once side effects)."""
    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir, exist_ok=True)
    gate = str(tmp_path / "gate")

    @ray_tpu_torch.remote
    def counted(tag, v):
        # Side-effect counter: one file per execution.
        open(os.path.join(marker_dir,
                          f"{tag}_{uuid.uuid4().hex[:6]}"), "w").close()
        return v * 2

    @ray_tpu_torch.remote
    def flaky(v):
        if not os.path.exists(gate):
            raise RuntimeError("transient failure")
        return v + 1

    with InputNode() as x:
        dag = flaky.bind(counted.bind("a", x))
    wid = f"w_{uuid.uuid4().hex[:6]}"
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id=wid, args=(4,))
    assert workflow.get_status(wid) == "FAILED"
    runs_a = [f for f in os.listdir(marker_dir) if f.startswith("a_")]
    assert len(runs_a) == 1

    open(gate, "w").close()   # heal the flake
    assert workflow.resume(wid) == 9   # 4*2 + 1
    assert workflow.get_status(wid) == "SUCCEEDED"
    # The completed step did NOT re-execute on resume.
    runs_a = [f for f in os.listdir(marker_dir) if f.startswith("a_")]
    assert len(runs_a) == 1


# ---------------------------------------------------- management surface


def test_event_gated_step(wf_cluster, wf_storage):
    """A step gated on workflow.event() parks until send_event delivers
    the value, which then flows into downstream steps."""
    import threading
    import time as _t

    ev = workflow.event("go", timeout_s=30)
    dag = _add.bind(ev, 5)
    wid, t = workflow.run_async(dag, workflow_id=f"ev_{uuid.uuid4().hex[:6]}")
    _t.sleep(0.5)
    assert workflow.get_status(wid) == "RUNNING"   # parked on the event
    workflow.send_event(wid, "go", 37)
    t.join(timeout=30)
    assert workflow.get_output(wid, timeout=30) == 42
    # Durability: a resume after success re-reads the delivered event.
    assert workflow.resume(wid) == 42


def test_event_timeout(wf_cluster, wf_storage):
    ev = workflow.event("never", timeout_s=0.5)
    dag = _add.bind(ev, 1)
    with pytest.raises(TimeoutError):
        workflow.run(dag, workflow_id="ev_timeout")
    assert workflow.get_status("ev_timeout") == "FAILED"


def test_cancel_at_step_boundary(wf_cluster, wf_storage):
    """cancel() during an event wait aborts the workflow as CANCELED."""
    import threading
    import time as _t

    ev = workflow.event("ghost", timeout_s=60)
    dag = _add.bind(ev, 1)
    wid, t = workflow.run_async(dag, workflow_id="cancel_me")
    _t.sleep(0.3)
    workflow.cancel(wid)
    t.join(timeout=10)
    assert workflow.get_status(wid) == "CANCELED"
    with pytest.raises(workflow.WorkflowCancelledError):
        workflow.get_output(wid, timeout=5)


def test_resume_all_after_driver_death(wf_cluster, wf_storage, tmp_path):
    """Simulated driver death: a subprocess starts a workflow whose second
    step blocks on an event, gets SIGKILLed, and resume_all() in this
    process finishes the work — with the first step's side effect NOT
    re-executed (exactly-once via its checkpoint)."""
    import subprocess
    import sys
    import time as _t

    storage = str(tmp_path / "wf")
    marker = str(tmp_path / "side_effect_count")
    # First step (bump) runs and checkpoints; the final step parks on an
    # event, so the SIGKILL lands between the two.
    code = f"""
import ray_tpu_torch
from ray_tpu_torch import workflow
ray_tpu_torch.init(num_cpus=2)
workflow.init({storage!r})

@ray_tpu_torch.remote
def bump(x):
    with open({marker!r}, "a") as f:
        f.write("x")
    return x + 1

@ray_tpu_torch.remote
def finish(a, gate):
    return a + gate

ev = workflow.event("finish", timeout_s=120)
dag = finish.bind(bump.bind(1), ev)
print("STARTING", flush=True)
workflow.run(dag, workflow_id="crashy")
"""
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "STARTING"
    # Wait for bump's checkpoint (step done) while finish parks on the event.
    deadline = _t.time() + 60
    while _t.time() < deadline and not os.path.exists(marker):
        _t.sleep(0.2)
    assert os.path.exists(marker)
    _t.sleep(0.5)   # let the bump checkpoint land
    subprocess.run(["pkill", "-9", "-P", str(proc.pid)], check=False)
    proc.kill()
    proc.wait()

    workflow.init(storage)
    assert workflow.get_status("crashy") == "RUNNING"   # stale: owner dead
    resumed = workflow.resume_all()
    assert "crashy" in resumed
    workflow.send_event("crashy", "finish", 40)
    assert workflow.get_output("crashy", timeout=60) == 42
    # Exactly-once: bump ran exactly once across both processes.
    assert open(marker).read() == "x"
