"""Workflow engine: DAG steps with durable per-step checkpoints.

Design analog: reference ``python/ray/workflow/api.py`` (run:120,
resume:232, get_output:297, resume_all:468, wait_for_event:557, cancel)
+ ``workflow_storage.py``: each step's output is pickled to
``<storage>/<workflow_id>/steps/<step_id>.pkl`` before the step is
considered done; resume loads completed steps instead of re-running them
(exactly-once per step).  Step ids are deterministic positions in the DAG
topology so the same DAG resumes against its own checkpoints.

Management surface:
  * ``get_output(wf_id, block=True)`` — wait for/return a workflow's
    final value from storage, regardless of which process runs it.
  * ``resume_all()`` — restart every resumable workflow (RUNNING with a
    dead owner pid, or FAILED); the post-crash recovery entry point.
  * ``event(name)`` / ``send_event(wf_id, name, value)`` — durable
    event-gated steps: the step completes when the event lands in
    storage (and stays satisfied across resumes).
  * ``cancel(wf_id)`` — request cancellation; the executor checks at
    every step boundary (running steps finish, like the reference).
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode, MultiOutputNode

_storage_dir: Optional[str] = None


class WorkflowCancelledError(Exception):
    """The workflow was cancelled via workflow.cancel()."""


class EventNode(DAGNode):
    """A step that completes when a named external event arrives.

    Durable: ``send_event`` writes the value under the workflow's storage,
    so an event received before a crash stays satisfied after resume, and
    a workflow parked on an un-sent event can be resumed and park again
    (reference ``api.py:557`` wait_for_event + event listeners).
    """

    def __init__(self, name: str, timeout_s: Optional[float] = None,
                 poll_interval_s: float = 0.2):
        super().__init__((), {})
        self.name = name
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s

    def _execute_self(self, resolved, input_args, input_kwargs):
        raise TypeError("EventNode only executes inside workflow.run() — "
                        "events need a workflow id to be delivered to")


def event(name: str, timeout_s: Optional[float] = None) -> EventNode:
    """DAG node gating on a named event (use as an upstream of .bind())."""
    return EventNode(name, timeout_s)


def send_event(workflow_id: str, name: str, value: Any = None) -> None:
    """Deliver an event to a workflow (from any process on this storage)."""
    d = os.path.join(_wf_dir(workflow_id), "events")
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(value, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, name + ".pkl"))


def init(storage: Optional[str] = None):
    """Set the workflow storage root (reference: workflow.init storage
    URI; local directories only here)."""
    global _storage_dir
    _storage_dir = storage or os.path.join(tempfile.gettempdir(),
                                           "rtt_workflows")
    os.makedirs(_storage_dir, exist_ok=True)
    return _storage_dir


def _storage() -> str:
    return _storage_dir or init()


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic step id per node: topo position + step name."""
    ids = {}
    for i, node in enumerate(dag.topo_order()):
        name = node.name if isinstance(node, FunctionNode) \
            else type(node).__name__
        ids[id(node)] = f"{i:04d}_{name}"
    return ids


def _meta_path(workflow_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), "meta.json")


def _write_meta(workflow_id: str, _only_if_status=None, **updates):
    """Read-modify-write of meta.json under an exclusive flock, so
    concurrent writers (executor finishing vs. cancel() from another
    process) cannot interleave.  ``_only_if_status`` makes the write
    conditional: it is dropped unless the current status is in the given
    set — cancel() must never overwrite a terminal SUCCEEDED/FAILED."""
    import fcntl
    path = _meta_path(workflow_id)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        meta = {}
        if os.path.exists(path):
            with open(path) as f:
                meta = json.load(f)
        if _only_if_status is not None and \
                meta.get("status") not in _only_if_status:
            return meta
        meta.update(updates)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    return meta


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        args: tuple = (), _dag_source=None) -> Any:
    """Execute the DAG durably; blocks and returns the final output."""
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    wf = _wf_dir(workflow_id)
    os.makedirs(os.path.join(wf, "steps"), exist_ok=True)
    # Persist the DAG itself so `resume(workflow_id)` works from a fresh
    # process without the user re-supplying it.
    from ray_tpu_torch._private import cloudpickle
    dag_path = os.path.join(wf, "dag.pkl")
    if not os.path.exists(dag_path):
        # The DAG pickle is what resume() rebuilds from — make it durable
        # before meta publishes RUNNING, or a crash leaves a workflow that
        # claims to be resumable with a torn dag.pkl.
        with open(dag_path, "wb") as f:
            cloudpickle.dump((dag, args), f)
            f.flush()
            os.fsync(f.fileno())
    _write_meta(workflow_id, status="RUNNING", start_time=time.time(),
                pid=os.getpid())
    try:
        result = _execute(dag, workflow_id, args)
        _write_meta(workflow_id, status="SUCCEEDED", end_time=time.time())
        return result
    except WorkflowCancelledError:
        _write_meta(workflow_id, status="CANCELED", end_time=time.time())
        raise
    except Exception as e:
        _write_meta(workflow_id, status="FAILED", error=str(e),
                    end_time=time.time())
        raise


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              args: tuple = ()):
    """Run in a daemon thread; returns (workflow_id, thread)."""
    import threading
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"

    def _bg():
        try:
            run(dag, workflow_id=workflow_id, args=args)
        except Exception:
            pass   # terminal status/error is in meta; get_output surfaces it

    t = threading.Thread(target=_bg, daemon=True)
    t.start()
    return workflow_id, t


def _execute(dag: DAGNode, workflow_id: str, input_args: tuple) -> Any:
    ids = _step_ids(dag)
    steps_dir = os.path.join(_wf_dir(workflow_id), "steps")
    resolved: Dict[int, Any] = {}

    def step_path(node):
        return os.path.join(steps_dir, ids[id(node)] + ".pkl")

    for node in dag.topo_order():
        # Cancellation is honored at step boundaries: the running step
        # finishes (its checkpoint stays valid for a later resume), then
        # the workflow stops (reference: workflow cancel semantics).
        if get_status(workflow_id) == "CANCEL_REQUESTED":
            raise WorkflowCancelledError(workflow_id)
        if isinstance(node, InputNode):
            if len(input_args) != 1:
                raise TypeError("workflow input must be a single value "
                                "(pass args=(value,))")
            resolved[id(node)] = input_args[0]
            continue
        if isinstance(node, MultiOutputNode):
            resolved[id(node)] = [node._resolve(a, resolved)
                                  for a in node._bound_args]
            continue
        if isinstance(node, EventNode):
            resolved[id(node)] = _wait_event(workflow_id, node)
            continue
        path = step_path(node)
        if os.path.exists(path):
            with open(path, "rb") as f:
                resolved[id(node)] = pickle.load(f)
            continue
        # Submit with materialized parent values (durable boundary: the
        # checkpoint, not the object store, is the source of truth).
        args = [node._resolve(a, resolved) for a in node._bound_args]
        kwargs = {k: node._resolve(v, resolved)
                  for k, v in node._bound_kwargs.items()}
        value = ray_tpu_torch.get(node._fn.remote(*args, **kwargs))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)   # atomic: a step is done iff its file exists
        resolved[id(node)] = value
    return resolved[id(dag)]


def _wait_event(workflow_id: str, node: EventNode) -> Any:
    """Block until the event file exists (cancel-aware); durable across
    resumes — an already-delivered event returns immediately."""
    path = os.path.join(_wf_dir(workflow_id), "events", node.name + ".pkl")
    deadline = (time.monotonic() + node.timeout_s
                if node.timeout_s is not None else None)
    while not os.path.exists(path):
        if get_status(workflow_id) == "CANCEL_REQUESTED":
            raise WorkflowCancelledError(workflow_id)
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"workflow {workflow_id}: event {node.name!r} not received "
                f"within {node.timeout_s}s")
        time.sleep(node.poll_interval_s)
    with open(path, "rb") as f:
        return pickle.load(f)


def cancel(workflow_id: str) -> None:
    """Request cancellation; the executor (this or any process) honors it
    at the next step boundary / event poll.  The conditional write makes
    cancel-vs-finish races safe: a workflow that reached a terminal state
    keeps it."""
    if get_status(workflow_id) is None:
        return
    _write_meta(workflow_id, _only_if_status=("RUNNING",),
                status="CANCEL_REQUESTED")


def resume_all(include_failed: bool = False) -> List[str]:
    """Resume every resumable workflow: status RUNNING whose owner pid is
    dead (driver crashed mid-run — reference api.py:468 resume_all), plus
    FAILED ones when include_failed.  Each resumes on a daemon thread;
    returns their ids (get_output(wf_id) joins them)."""
    resumed = []
    for info in list_all():
        status = info.get("status")
        pid = info.get("pid")
        dead_owner = pid is not None and not os.path.exists(f"/proc/{pid}")
        if (status == "RUNNING" and dead_owner) or \
                (include_failed and status == "FAILED"):
            wid = info["workflow_id"]
            import threading
            threading.Thread(target=_safe_resume, args=(wid,),
                             daemon=True).start()
            resumed.append(wid)
    return resumed


def _safe_resume(workflow_id: str) -> None:
    try:
        resume(workflow_id)
    except Exception:
        pass   # status lands in meta; get_output surfaces it


def _load_dag(workflow_id: str):
    from ray_tpu_torch._private import cloudpickle
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if not os.path.exists(dag_path):
        raise ValueError(f"no stored workflow {workflow_id!r}")
    with open(dag_path, "rb") as f:
        return cloudpickle.load(f)


def resume(workflow_id: str) -> Any:
    """Re-run a workflow from storage; completed steps load from their
    checkpoints (reference api.py:232)."""
    dag, args = _load_dag(workflow_id)
    return run(dag, workflow_id=workflow_id, args=args)


def get_status(workflow_id: str) -> Optional[str]:
    path = _meta_path(workflow_id)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("status")


def get_output(workflow_id: str, block: bool = True,
               timeout: Optional[float] = None) -> Any:
    """Final output of a workflow (reference api.py:297 get_output).

    Blocks while the workflow is RUNNING (it may be executing in another
    process — progress is observed through storage).  Raises on FAILED /
    CANCELED, GetTimeoutError on timeout, ValueError if unknown."""
    deadline = time.monotonic() + timeout if timeout is not None else None
    while True:
        status = get_status(workflow_id)
        if status is None:
            raise ValueError(f"no such workflow {workflow_id!r}")
        if status == "SUCCEEDED":
            # Every step checkpointed: re-driving the DAG is pure reads
            # (no meta rewrite — concurrent observers keep seeing
            # SUCCEEDED, unlike a full resume()).
            dag, args = _load_dag(workflow_id)
            return _execute(dag, workflow_id, args)
        if status == "CANCELED":
            raise WorkflowCancelledError(workflow_id)
        if status == "FAILED":
            with open(_meta_path(workflow_id)) as f:
                raise RuntimeError(
                    f"workflow {workflow_id} failed: "
                    f"{json.load(f).get('error')}")
        if not block:
            raise ValueError(f"workflow {workflow_id} is {status}")
        if deadline is not None and time.monotonic() > deadline:
            from ray_tpu_torch.exceptions import GetTimeoutError
            raise GetTimeoutError(
                f"workflow {workflow_id} still {status} after {timeout}s")
        time.sleep(0.2)


def list_all() -> List[Dict[str, Any]]:
    root = _storage()
    out = []
    for wid in sorted(os.listdir(root)):
        meta = _meta_path(wid)
        if os.path.exists(meta):
            with open(meta) as f:
                out.append({"workflow_id": wid, **json.load(f)})
    return out
