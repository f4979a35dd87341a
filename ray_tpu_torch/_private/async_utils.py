"""Shared asyncio task-spawning helpers.

Every control-plane component fires background tasks (dispatch kicks,
pubsub publishes, reply writers).  A bare ``loop.create_task(coro())``
drops the only reference to the Task: if the coroutine raises, the
exception sits unobserved until the Task is GC'd and then surfaces as
an opaque "Task exception was never retrieved" destructor warning —
long after the causal context is gone, and invisible under test
runners that swallow the warning.  ``spawn()`` is the sanctioned
fire-and-forget: it attaches ``_log_task_exception`` so failures hit
the component's logger immediately, with the task name attached.

rtlint's orphan-task rule flags bare ``create_task``/``ensure_future``
statements and recognizes ``spawn()`` as the fix (see docs/LINT.md).

Dependency-free (stdlib asyncio + logging only) so the lowest layers
(protocol.py) can import it without cycles.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Coroutine, Optional

logger = logging.getLogger("ray_tpu_torch.async")


def _log_task_exception(task: "asyncio.Task",
                        log: Optional[logging.Logger] = None) -> None:
    """Done-callback: surface non-cancellation exceptions of a
    fire-and-forget task through the logger instead of the GC."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is None:
        return
    (log or logger).error("background task %r failed: %r",
                          task.get_name(), exc,
                          exc_info=(type(exc), exc, exc.__traceback__))


def spawn(coro: "Coroutine", *, name: Optional[str] = None,
          loop: Optional["asyncio.AbstractEventLoop"] = None,
          log: Optional[logging.Logger] = None) -> "asyncio.Task":
    """create_task/ensure_future with the exception-logging done
    callback attached.  ``loop`` routes through ``ensure_future`` for
    call sites that hold an explicit loop reference (pre-running-loop
    setup paths); otherwise the running loop is used."""
    if loop is not None:
        task = asyncio.ensure_future(coro, loop=loop)
    else:
        task = asyncio.get_running_loop().create_task(coro)
    if name and hasattr(task, "set_name"):
        task.set_name(name)
    task.add_done_callback(
        lambda t: _log_task_exception(t, log))
    return task
