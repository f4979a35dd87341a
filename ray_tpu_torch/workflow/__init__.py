"""Durable workflow execution over DAGs.

Design analog: reference ``python/ray/workflow/`` — ``workflow.run``
(api.py:120), ``workflow.resume`` (api.py:232): run a task DAG with every
step's output checkpointed to storage, so a crashed run resumes from the
last completed step with exactly-once step execution.
"""

from ray_tpu_torch.workflow.api import (WorkflowCancelledError, cancel, event,
                                  get_output, get_status, init, list_all,
                                  resume, resume_all, run, run_async,
                                  send_event)

__all__ = ["init", "run", "run_async", "resume", "resume_all", "cancel",
           "event", "send_event", "get_output", "get_status", "list_all",
           "WorkflowCancelledError"]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("workflow")
del _rlu
