"""WorkerGroup: a gang of train-worker actors.

Port of ``ray_tpu/train/_internal/worker_group.py`` (reference
``python/ray/train/_internal/worker_group.py:92``: WorkerGroup with
execute/execute_async over RayTrainWorker actors).  Each worker is one
actor == one process, which owns the whole cards its bundle granted: the
runtime sets its ``CUDA_VISIBLE_DEVICES`` to them before the process
starts, so a worker's ``cuda:0`` is its first card.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint


class Preempted(BaseException):
    """Raised inside the train loop by session.report at the step boundary
    after a preemption notice, unwinding the user fn AFTER its final
    checkpoint-bearing report so the worker exits clean.  BaseException so
    a user loop's broad ``except Exception`` cannot swallow the handoff."""


class RayTrainWorker:
    """Actor body hosting the user's train loop in a background thread.

    The reference pushes results through a queue consumed by the driver
    (train/_internal/session.py:325); here `get_next` blocks on that queue
    from the driver side.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._ctx: Dict[str, Any] = {}
        # Monotonic deadline by which this worker must be gone, set by a
        # preempt() RPC or the preempt_notice fault; None = no notice.
        self._preempt_deadline: Optional[float] = None

    # -- plumbing ---------------------------------------------------------
    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process (setup hooks)."""
        return fn(*args, **kwargs)

    def node_ip(self) -> str:
        """The host part of this worker's node address, as the GCS
        records it (the address other nodes reach the node at)."""
        node_id = ray_tpu_torch.get_runtime_context().get_node_id()
        for node in ray_tpu_torch.nodes():
            if node["node_id"] == node_id:
                return node["address"].rsplit(":", 1)[0]
        raise RuntimeError(f"node {node_id[:12]} is not in the GCS's table")

    def set_env_vars(self, env: Dict[str, str]):
        os.environ.update(env)

    def set_context(self, **ctx):
        self._ctx.update(ctx)

    # -- preemption -------------------------------------------------------
    def preempt(self, grace_s: float = 30.0) -> bool:
        """Deliver a preemption notice: the train loop finishes its
        in-flight microbatch, writes a final checkpoint at the next step
        boundary, and exits clean (a planned handoff, not a failure).
        Callable as an actor RPC (max_concurrency > 1 lets it land while
        the loop runs); the preempt_notice fault delivers the same signal
        in-process for chaos tests."""
        self._preempt_deadline = time.monotonic() + float(grace_s)
        return True

    def _preempt_deadline_check(self) -> Optional[float]:
        """The active grace deadline, arming the fault-injected notice on
        first observation past its fire time.  Consulted by the session at
        every report (step boundary)."""
        if self._preempt_deadline is None:
            from ray_tpu_torch.util import fault_injection
            notice = fault_injection.preempt_notice_at(
                self._ctx.get("world_rank", 0))
            if notice is not None and time.monotonic() >= notice[0]:
                self._preempt_deadline = notice[0] + notice[1]
        return self._preempt_deadline

    # -- training ---------------------------------------------------------
    def start_training(self, train_fn: Callable,
                       config: Optional[Dict[str, Any]],
                       checkpoint: Optional[Checkpoint]):
        ctx = self._ctx
        q = self._queue
        worker = self

        class _TrainSession(air_session._SessionBase):
            world_rank = ctx.get("world_rank", 0)
            world_size = ctx.get("world_size", 1)
            local_rank = ctx.get("local_rank", 0)
            local_world_size = ctx.get("local_world_size", 1)
            node_rank = ctx.get("node_rank", 0)
            trial_name = ctx.get("trial_name", "")
            trial_id = ctx.get("trial_id", "")
            experiment_name = ctx.get("experiment_name", "")

            def report(self, metrics, ckpt=None):
                q.put(("report", metrics, ckpt))
                # Step boundary = the preemption exit point: leave after
                # the first checkpoint-bearing report once noticed, or at
                # any report past the grace deadline (the platform is
                # about to SIGKILL us; clean exit without a fresh
                # checkpoint still beats an unplanned death).
                deadline = worker._preempt_deadline_check()
                if deadline is not None and (
                        ckpt is not None or time.monotonic() >= deadline):
                    raise Preempted(
                        f"rank={self.world_rank} preempted "
                        f"(grace deadline {deadline:.1f})")

            def get_checkpoint(self):
                return checkpoint

        def _run():
            air_session._set_session(_TrainSession())
            try:
                # Match the reference's construct_train_func: a loop taking a
                # parameter receives the (possibly empty) config dict.
                import inspect
                takes_arg = bool(
                    inspect.signature(train_fn).parameters)
                if takes_arg:
                    result = train_fn(config if config is not None else {})
                else:
                    result = train_fn()
                q.put(("done", result, None))
            # rtlint: disable=cancellation-safety - thread boundary: the
            # preemption is forwarded over the result queue and re-raised
            # driver-side by the supervisor, not swallowed.
            except Preempted as e:
                q.put(("preempted", str(e), None))
            # rtlint: disable=cancellation-safety - thread boundary:
            # forwarded to the driver over the result queue; raising here
            # would kill the train thread with no report.
            except BaseException as e:  # noqa: BLE001 - forwarded to driver
                q.put(("error", repr(e), traceback.format_exc()))
            finally:
                air_session._set_session(None)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="train_loop")
        self._thread.start()
        return True

    def get_next(self):
        """Block until the train loop reports, finishes, or errors."""
        return self._queue.get()

    def shutdown(self):
        return True


class Worker:
    def __init__(self, actor, rank: int):
        self.actor = actor
        self.rank = rank
        self.actor_id: str = getattr(actor, "_actor_id_hex", "")
        self.ip: str = ""
        self.node_rank: int = 0
        self.local_rank: int = 0


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_group=None,
                 bundle_offset: int = 0,
                 group_id: Optional[str] = None):
        self._num_workers = num_workers
        # Workers get GCS-registered names (_train:<gang>:<rank>) so the
        # gang supervisor's death watch and chaos's kill_train_worker can
        # target them by identity — ActorInfo carries no class name.
        self.group_id = group_id or uuid.uuid4().hex[:8]
        cls = ray_tpu_torch.remote(RayTrainWorker)
        self.workers: List[Worker] = []
        for rank in range(num_workers):
            opts: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1.0),
                "num_gpus": resources_per_worker.get("GPU", 0.0),
                "max_concurrency": 4,
                "name": f"_train:{self.group_id}:{rank}",
            }
            extra = {k: v for k, v in resources_per_worker.items()
                     if k not in ("CPU", "GPU")}
            if extra:
                opts["resources"] = extra
            if placement_group is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
                opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group,
                    placement_group_bundle_index=bundle_offset + rank)
            actor = cls.options(**opts).remote()
            self.workers.append(Worker(actor, rank))
        # Resolve IPs and derive node/local ranks (reference
        # backend_executor.py:245 _create_rank_map).
        ips = ray_tpu_torch.get([w.actor.node_ip.remote()
                                 for w in self.workers])
        node_order: List[str] = []
        local_counts: Dict[str, int] = {}
        for w, ip in zip(self.workers, ips):
            w.ip = ip
            if ip not in node_order:
                node_order.append(ip)
            w.node_rank = node_order.index(ip)
            w.local_rank = local_counts.get(ip, 0)
            local_counts[ip] = w.local_rank + 1
        self._local_world = local_counts

    def __len__(self):
        return self._num_workers

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.actor.execute.remote(fn, *args, **kwargs)
                for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(
            self.workers[rank].actor.execute.remote(fn, *args, **kwargs))

    def local_world_size(self, ip: str) -> int:
        return self._local_world.get(ip, 1)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w.actor)
            except Exception:
                pass
        self.workers = []
