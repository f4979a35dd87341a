"""Remote debugger (rpdb) tests.

Reference shape: python/ray/util/rpdb.py + ray debug — a breakpoint in a
remote task registers with the GCS, a client attaches over TCP, inspects
frame state, and `c` resumes the task.

The port's, case for case those of ``test_rpdb.py``.  This module
imports nothing of JAX: the cluster's workers import it.
"""

import io
import time

from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.util import rpdb


def _breakpoint_task():
    x = 41
    ray_tpu_torch.util.rpdb.set_trace(timeout_s=30)
    return x + 1


def test_set_trace_times_out_without_client():
    """An unattended breakpoint must NOT wedge the task (CI safety —
    divergence from the reference, which blocks forever)."""
    t0 = time.monotonic()
    rpdb.set_trace(timeout_s=0.5)
    assert time.monotonic() - t0 < 10


def test_remote_breakpoint_attach_inspect_continue(ray_start):
    """End to end: task hits set_trace, driver finds the session via the
    GCS, attaches, evaluates a local variable in the task's frame, then
    continues it to completion."""
    task = ray_tpu_torch.remote(_breakpoint_task)
    ref = task.remote()

    # Wait for the session to appear in the GCS KV.
    deadline = time.monotonic() + 20
    sessions = []
    while time.monotonic() < deadline:
        sessions = rpdb.list_sessions()
        if sessions:
            break
        time.sleep(0.2)
    assert sessions, "breakpoint session never registered"
    s = sessions[0]
    assert s["function"] == "_breakpoint_task"

    # Drive pdb programmatically: print the local, then continue.
    out = io.StringIO()
    rpdb.connect(s, stdin=io.StringIO("p x\nc\n"), stdout=out)
    transcript = out.getvalue()
    assert "rpdb attached" in transcript
    assert "41" in transcript          # `p x` output

    assert ray_tpu_torch.get(ref, timeout=30) == 42
    # Session must deregister after detach.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and rpdb.list_sessions():
        time.sleep(0.2)
    assert not rpdb.list_sessions()
