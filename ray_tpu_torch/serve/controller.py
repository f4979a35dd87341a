"""Serve controller: reconciles declared deployments to replica actors.

Reference analogs: ServeController (serve/controller.py:64),
DeploymentState/DeploymentStateManager replica lifecycle
(_private/deployment_state.py:959,1769), BasicAutoscalingPolicy on queue
metrics (_private/autoscaling_policy.py:93).

The controller is a detached async actor.  A reconcile loop drives each
deployment's replica set toward its target count, probes replica health,
replaces dead replicas, and (when autoscaling is configured) adjusts the
target from the replicas' reported queue depths — scale-up when the mean
outstanding queue exceeds the target, scale-down when it falls well below.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_serve_controller"
RECONCILE_PERIOD_S = 0.5


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class DeploymentSpec:
    name: str
    callable_blob: bytes          # cloudpickle (cls_or_fn, args, kwargs)
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    route_prefix: str = ""
    resources: Optional[Dict[str, float]] = None
    num_cpus: float = 1.0
    autoscaling: Optional[Dict[str, Any]] = None  # min/max_replicas,
    #                                              target_queue_len
    # Arbitrary config pushed to live replicas via reconfigure() without a
    # restart (reference: deployment user_config + replica reconfigure).
    user_config: Optional[Dict[str, Any]] = None
    # Per-replica runtime env (reference: ray_actor_options.runtime_env);
    # e.g. env_vars giving one deployment's workers a setting the
    # cluster default does not have.  It cannot move the replica's cards:
    # the raylet sets CUDA_VISIBLE_DEVICES after the env_vars.
    runtime_env: Optional[Dict[str, Any]] = None


class Replica:
    """Actor body hosting one deployment replica."""

    def __init__(self, callable_blob: bytes, max_concurrent_queries: int = 8,
                 user_config: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch._private import cloudpickle
        target, args, kwargs = cloudpickle.loads(callable_blob)
        if isinstance(target, type):
            self._fn = target(*args, **kwargs)
        else:
            self._fn = target
        if user_config is not None:
            self.reconfigure(user_config)
        self._outstanding = 0
        # Concurrency is bounded HERE, not by the actor's max_concurrency:
        # requests waiting on an actor-level semaphore would be invisible to
        # queue_len, capping the autoscaler's signal at the concurrency
        # limit no matter how deep the real backlog is.
        self._sem = asyncio.Semaphore(max_concurrent_queries)

    @staticmethod
    def _resolve(fn):
        import inspect
        # Resolve a class instance to its bound __call__ so coroutine /
        # generator detection sees the real function.
        if (not inspect.isfunction(fn) and not inspect.ismethod(fn)
                and callable(fn) and hasattr(fn, "__call__")):
            fn = fn.__call__
        return fn

    async def handle_request(self, args, kwargs,
                             method: Optional[str] = None,
                             deadline: Optional[float] = None):
        import functools

        from ray_tpu_torch.serve import resilience

        async def _invoke():
            fn = self._resolve(
                self._fn if method is None else getattr(self._fn, method))
            if asyncio.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                # Sync handlers must not block the replica's event loop:
                # run them on threads; self._sem bounds the fan-out.
                result = \
                    await asyncio.get_running_loop().run_in_executor(
                        None, functools.partial(fn, *args, **kwargs))
                if asyncio.iscoroutine(result):
                    result = await result
            # A generator-handler called through the unary path drains
            # to a list — the raw generator object is replica-local
            # and would fail to pickle into the reply.
            if hasattr(result, "__anext__"):
                return [item async for item in result]
            if hasattr(result, "__next__") and hasattr(result, "send"):
                return await asyncio.get_running_loop().run_in_executor(
                    None, list, result)
            return result

        self._outstanding += 1
        # Publish the end-to-end deadline to the handler body (the
        # inference engine reads it to bound decode); the wait_for below
        # is the backstop for handlers that never look.
        token = resilience.set_deadline(deadline)
        try:
            rem = resilience.deadline_remaining(deadline)
            if rem is not None and rem <= 0:
                raise resilience.DeadlineExceeded(
                    "deadline expired before the replica started")
            async with self._sem:
                rem = resilience.deadline_remaining(deadline)
                if rem is None:
                    return await _invoke()
                if rem <= 0:
                    raise resilience.DeadlineExceeded(
                        "deadline expired while queued on the replica")
                try:
                    return await asyncio.wait_for(_invoke(), rem)
                except asyncio.TimeoutError:
                    raise resilience.DeadlineExceeded(
                        "deadline expired during the request") from None
        finally:
            resilience.reset_deadline(token)
            self._outstanding -= 1

    async def handle_stream(self, args, kwargs,
                            method: Optional[str] = None,
                            deadline: Optional[float] = None):
        """Streaming twin of handle_request: an async generator the owner
        consumes per-item via ``num_returns="streaming"`` — the caller
        sees each yield while the handler is still running.  Sync
        generators are stepped on threads so they can block; plain
        (non-generator) results degrade to a single-item stream.
        ``_outstanding``/the semaphore span the WHOLE stream life, so
        queue_len (the autoscaler signal) counts live streams, not just
        call setup.  The request ``deadline`` is published through
        ``resilience.set_deadline`` for the handler (the engine bounds
        decode with it) and re-checked here at every yield."""
        import functools

        from ray_tpu_torch.serve import resilience
        from ray_tpu_torch.util import fault_injection

        def _check_deadline():
            rem = resilience.deadline_remaining(deadline)
            if rem is not None and rem <= 0:
                raise resilience.DeadlineExceeded(
                    "deadline expired mid-stream")

        self._outstanding += 1
        token = resilience.set_deadline(deadline)
        try:
            _check_deadline()
            async with self._sem:
                _check_deadline()
                fn = self._resolve(
                    self._fn if method is None else getattr(self._fn, method))
                loop = asyncio.get_running_loop()
                if asyncio.iscoroutinefunction(fn):
                    result = await fn(*args, **kwargs)
                else:
                    result = fn(*args, **kwargs)
                    if asyncio.iscoroutine(result):
                        result = await result
                if hasattr(result, "__anext__"):
                    async for item in result:
                        stall = fault_injection.stall_stream_s()
                        if stall:
                            await asyncio.sleep(stall)
                        _check_deadline()
                        yield item
                elif hasattr(result, "__next__") and hasattr(result, "send"):
                    sentinel = object()
                    _next = functools.partial(next, result, sentinel)
                    try:
                        while True:
                            item = await loop.run_in_executor(None, _next)
                            if item is sentinel:
                                break
                            stall = fault_injection.stall_stream_s()
                            if stall:
                                await asyncio.sleep(stall)
                            _check_deadline()
                            yield item
                    finally:
                        close = getattr(result, "close", None)
                        if close is not None:
                            await loop.run_in_executor(None, close)
                else:
                    yield result
        finally:
            resilience.reset_deadline(token)
            self._outstanding -= 1

    def reconfigure(self, user_config: Dict[str, Any]) -> bool:
        """Apply a user_config update in place (reference: the replica
        calls the user class's reconfigure(user_config) on deploy-time
        config changes — no restart)."""
        hook = getattr(self._fn, "reconfigure", None)
        if hook is None:
            raise ValueError(
                "deployment has user_config but its class defines no "
                "reconfigure(user_config) method")
        hook(user_config)
        return True

    def queue_len(self) -> int:
        return self._outstanding

    def ping(self) -> bool:
        return True


class ServeController:
    def __init__(self):
        self.deployments: Dict[str, DeploymentSpec] = {}
        self.replicas: Dict[str, List] = {}        # name -> actor handles
        self.targets: Dict[str, int] = {}          # name -> target count
        self._replica_seq = 0
        self._shutdown = False
        self._loop_task = None
        self._metrics: Dict[str, List[float]] = {}  # queue-len history
        # Health-probe grace for initializing replicas (reference:
        # initial health-check period in deployment_state): a replica
        # whose __init__ is still loading a model onto its card must not be
        # killed for missing a 10s ping.  actor_id -> created monotonic;
        # ids that have answered once graduate to the normal probe.
        self._replica_created: Dict[str, float] = {}
        self._replica_seen_healthy: set = set()
        # deploy() and the background loop both reconcile; without this
        # lock a concurrent `reps[:] = alive` clobbers (and orphans)
        # replicas the other invocation just created.
        self._reconcile_lock = asyncio.Lock()
        # Long-poll state (reference serve/_private/long_poll.py
        # LongPollHost): per-deployment replica-set version + waiter event.
        self._versions: Dict[str, int] = {}
        self._change_events: Dict[str, asyncio.Event] = {}
        self._restored = False

    async def _maybe_restore(self):
        """Crash recovery (reference: the controller checkpoints its
        state and recovers on restart): a GCS-restarted controller
        re-adopts its deployments AND the still-live replica actors from
        the KV snapshot written each reconcile — replicas keep serving
        through the crash; reconcile then replaces any that died."""
        if self._restored:
            return
        self._restored = True
        try:
            from ray_tpu_torch._private import cloudpickle
            from ray_tpu_torch._private.worker import get_core
            from ray_tpu_torch.actor import ActorHandle
            raw = await get_core().gcs.request(
                {"type": "kv_get", "ns": "serve", "key": b"state"})
            if not raw:
                return
            state = cloudpickle.loads(raw)
            self._replica_seq = state.get("replica_seq", 0)
            for name, (spec, target, replica_ids) in \
                    state.get("deployments", {}).items():
                self.deployments[name] = spec
                self.targets[name] = target
                self.replicas[name] = [ActorHandle(a, "Replica")
                                       for a in replica_ids]
                self._bump_version(name)   # routers refresh handles
            if self.deployments:
                logger.info("serve controller restored %d deployments "
                            "from KV", len(self.deployments))
        except Exception:
            logger.exception("serve controller state restore failed")

    def _bump_version(self, name: str):
        self._versions[name] = self._versions.get(name, 0) + 1
        ev = self._change_events.pop(name, None)
        if ev is not None:
            ev.set()

    async def listen_for_change(self, name: str, last_version: int,
                                timeout: float = 30.0) -> Dict[str, Any]:
        await self._maybe_restore()
        await self._ensure_loop()
        """Long-poll: parks until the deployment's replica set differs from
        ``last_version`` (or timeout), then returns the current snapshot.
        Routers learn about scale events push-style instead of waiting out
        a TTL (reference long_poll.py:listen_for_change)."""
        cur = self._versions.get(name, 0)
        if cur == last_version:
            ev = self._change_events.setdefault(name, asyncio.Event())
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            cur = self._versions.get(name, 0)
        return {"version": cur,
                "replicas": list(self.replicas.get(name, []))}

    async def _ensure_loop(self):
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self._reconcile_loop())

    async def deploy(self, spec: DeploymentSpec) -> bool:
        """Create or update a deployment (idempotent goal-state write).

        A changed callable/config replaces every existing replica — old
        replicas would otherwise keep serving the old code forever (the
        reference rolls replicas on version change,
        deployment_state.py:959)."""
        await self._ensure_loop()
        await self._maybe_restore()
        old = self.deployments.get(spec.name)
        code_changed = old is not None and (
            old.callable_blob != spec.callable_blob or
            old.max_concurrent_queries != spec.max_concurrent_queries or
            old.num_cpus != spec.num_cpus or
            old.resources != spec.resources or
            old.runtime_env != spec.runtime_env)
        config_changed = (old is not None and not code_changed
                          and old.user_config != spec.user_config)
        self.deployments[spec.name] = spec
        self.targets[spec.name] = spec.num_replicas
        if spec.autoscaling:
            lo = spec.autoscaling.get("min_replicas", 1)
            hi = spec.autoscaling.get("max_replicas", spec.num_replicas)
            self.targets[spec.name] = min(max(spec.num_replicas, lo), hi)
        self.replicas.setdefault(spec.name, [])
        if code_changed:
            async with self._reconcile_lock:
                for r in self.replicas.get(spec.name, []):
                    await self._kill_replica(r)
                self.replicas[spec.name] = []
        elif config_changed:
            # Lightweight path: push the new user_config into live
            # replicas in place — no restart, in-flight requests unharmed.
            async with self._reconcile_lock:
                for r in self.replicas.get(spec.name, []):
                    await asyncio.wait_for(
                        r.reconfigure.remote(spec.user_config), timeout=30)
        await self._reconcile_once()
        return True

    async def _kill_replica(self, handle,
                            drain_s: Optional[float] = None):
        """Drain then kill (reference: replica graceful shutdown —
        deployment_state waits for in-flight requests before stopping).
        Bounded by ``RT_SERVE_DRAIN_S`` (poll cadence
        ``RT_SERVE_DRAIN_POLL_S``): a wedged request must not block
        scale-down forever.  Streams still live at the deadline are
        killed with the replica and complete through the ingress's
        mid-stream failover — counted as ``drain_handoffs`` and logged
        as a drain_timeout so operators can tell graceful drains from
        forced ones.  Async kill: the blocking ray_tpu_torch.kill would
        deadlock the actor loop this controller runs on."""
        if drain_s is None:
            drain_s = _env_f("RT_SERVE_DRAIN_S", 10.0)
        poll_s = max(0.01, _env_f("RT_SERVE_DRAIN_POLL_S", 0.1))
        deadline = time.monotonic() + drain_s
        leftover = 0
        while True:
            try:
                leftover = await asyncio.wait_for(
                    handle.queue_len.remote(), timeout=2)
            except Exception:
                leftover = 0
                break   # dead/unreachable: nothing to drain
            if leftover == 0 or time.monotonic() >= deadline:
                break
            await asyncio.sleep(poll_s)
        if leftover:
            logger.warning(
                "serve: drain_timeout — replica %s still had %d in-flight "
                "request(s) after %.1fs; force-failing them over",
                handle._actor_id[:8], leftover, drain_s)
            from ray_tpu_torch.serve import metrics as serve_metrics
            serve_metrics.bump("drain_handoffs", leftover)
        from ray_tpu_torch._private.worker import get_core
        try:
            await get_core().gcs.request({"type": "kill_actor",
                                          "actor_id": handle._actor_id,
                                          "no_restart": True})
        except Exception:
            pass
        # keep the health-grace bookkeeping bounded under replica churn
        self._replica_created.pop(handle._actor_id, None)
        self._replica_seen_healthy.discard(handle._actor_id)

    async def rolling_restart(self, name: str) -> Dict[str, Any]:
        """Replace every replica of ``name`` one at a time with zero
        dropped streams (reference: deployment_state's rolling update,
        one-at-a-time flavor).  Per replica: (1) surge-create the
        replacement and wait until it answers a ping, so serving capacity
        never dips below target; (2) under the reconcile lock, swap it
        into the routing set and bump the long-poll version — routers and
        ingresses stop sending to the victim push-style BEFORE it stops;
        (3) outside the lock, drain the victim (RT_SERVE_DRAIN_S) and
        kill it — streams still live at the drain deadline complete
        through the ingress's mid-stream failover (drain_handoffs)."""
        await self._maybe_restore()
        await self._ensure_loop()
        spec = self.deployments.get(name)
        if spec is None:
            raise ValueError(f"no deployment named {name!r}")
        old_ids = [r._actor_id for r in self.replicas.get(name, [])]
        replaced = 0
        skipped = 0
        for aid in old_ids:
            async with self._reconcile_lock:
                reps = self.replicas.setdefault(name, [])
                victim = next(
                    (r for r in reps if r._actor_id == aid), None)
                if victim is None:
                    skipped += 1   # died and was replaced mid-rollout
                    continue
                fresh = await self._create_replica(name, spec)
                try:
                    await asyncio.wait_for(fresh.ping.remote(),
                                           timeout=120)
                    self._replica_seen_healthy.add(fresh._actor_id)
                except Exception:
                    await self._kill_replica(fresh, drain_s=0)
                    raise RuntimeError(
                        f"rolling_restart({name!r}): replacement replica "
                        "failed to become ready; aborting rollout")
                reps.remove(victim)
                reps.append(fresh)
                # Stop-routing-first: the version bump reaches routers
                # and ingresses (long-poll push) before the victim is
                # touched, so no NEW request lands on it while draining.
                self._bump_version(name)
            await self._kill_replica(victim)
            replaced += 1
        logger.info("serve: rolling restart of %s replaced %d replica(s)"
                    " (%d already gone)", name, replaced, skipped)
        return {"deployment": name, "replaced": replaced,
                "skipped": skipped}

    async def delete_deployment(self, name: str) -> bool:
        # Under the reconcile lock: an in-flight reconcile that already
        # snapshotted this deployment would otherwise recreate (and orphan)
        # replicas right after we kill them.
        await self._maybe_restore()
        async with self._reconcile_lock:
            self.deployments.pop(name, None)
            self.targets.pop(name, None)
            victims = self.replicas.pop(name, [])
            # Routers stop sending FIRST (long-poll push), then drain:
            # draining a replica that still receives traffic never ends.
            self._bump_version(name)
            for r in victims:
                await self._kill_replica(r)
        return True

    async def status(self) -> Dict[str, Any]:
        await self._maybe_restore()
        return {
            name: {
                "target": self.targets.get(name, 0),
                "running": len(self.replicas.get(name, [])),
                "route_prefix": spec.route_prefix,
            }
            for name, spec in self.deployments.items()
        }

    async def get_replicas(self, name: str) -> List:
        """Replica handles for the router (cached client-side)."""
        await self._maybe_restore()
        await self._ensure_loop()   # a restarted controller reconciles
        return list(self.replicas.get(name, []))

    async def routes(self) -> Dict[str, str]:
        """route_prefix -> deployment name (for the HTTP ingress)."""
        return {spec.route_prefix: name
                for name, spec in self.deployments.items()
                if spec.route_prefix}

    async def shutdown(self) -> bool:
        self._shutdown = True
        for name in list(self.deployments):
            await self.delete_deployment(name)
        return True

    # ------------------------------------------------------------ internals

    async def _reconcile_loop(self):
        await self._maybe_restore()
        while not self._shutdown:
            try:
                await self._reconcile_once()
                await self._autoscale()
                await self._publish_status()
            except Exception:
                logger.exception("serve reconcile failed")
            await asyncio.sleep(RECONCILE_PERIOD_S)

    async def _publish_status(self):
        """Push app status into GCS KV so the dashboard (which lives in
        the GCS process, not a worker) can serve /api/serve without a
        cluster client (reference: dashboard/modules/serve/ reads the
        controller through ray calls; here KV is the decoupling).  Uses
        the async GCS channel directly — this coroutine runs ON the core
        IO loop, where the blocking kv_put wrapper would deadlock."""
        import json as _json

        from ray_tpu_torch._private.worker import get_core
        status = {
            name: {
                "target": self.targets.get(name, 0),
                "running": len(self.replicas.get(name, [])),
                "route_prefix": spec.route_prefix,
            }
            for name, spec in self.deployments.items()
        }
        await get_core().gcs.request({
            "type": "kv_put", "ns": "serve", "key": b"status",
            "value": _json.dumps({"deployments": status,
                                  "updated_at": time.time()}).encode(),
            "overwrite": True})
        from ray_tpu_torch._private import cloudpickle
        state = {
            "replica_seq": self._replica_seq,
            "deployments": {
                name: (spec, self.targets.get(name, 0),
                       [r._actor_id for r in self.replicas.get(name, [])])
                for name, spec in self.deployments.items()
            },
        }
        await get_core().gcs.request({
            "type": "kv_put", "ns": "serve", "key": b"state",
            "value": cloudpickle.dumps(state), "overwrite": True})

    async def _create_replica(self, name: str, spec: DeploymentSpec):
        """Create one replica actor for ``name`` and return its handle.
        Callers must hold ``_reconcile_lock`` (or be the reconcile loop
        itself) — creation mutates the shared replica bookkeeping."""
        from ray_tpu_torch._private.worker import get_core
        from ray_tpu_torch.actor import ActorHandle
        self._replica_seq += 1
        resources = {"CPU": spec.num_cpus, **(spec.resources or {})}
        # max_concurrency has headroom over the request bound: requests
        # queue inside the replica (visible to queue_len) instead of at
        # the actor layer.
        scheduling = None
        if spec.runtime_env:
            from ray_tpu_torch.remote_function import _build_scheduling
            scheduling = _build_scheduling(
                {"runtime_env": spec.runtime_env})
        actor_id = await get_core().create_actor_async(
            Replica,
            (spec.callable_blob, spec.max_concurrent_queries,
             spec.user_config),
            {},
            resources=resources,
            scheduling=scheduling,
            max_concurrency=4 * spec.max_concurrent_queries + 8,
            name=f"_serve:{name}:{self._replica_seq}")
        self._replica_created[actor_id] = time.monotonic()
        return ActorHandle(actor_id, "Replica")

    async def _reconcile_once(self):
        async def probe(r):
            aid = r._actor_id
            fresh = aid not in self._replica_seen_healthy
            if fresh and time.monotonic() - self._replica_created.get(
                    aid, 0.0) < 120.0:
                # Init grace: give a replica still constructing (model
                # load onto the card) the full window before the 10s
                # liveness bar applies.
                try:
                    await asyncio.wait_for(r.ping.remote(), timeout=1.0)
                    self._replica_seen_healthy.add(aid)
                except Exception:
                    pass
                return True
            try:
                # ObjectRef is awaitable; wait_for wraps it.
                await asyncio.wait_for(r.ping.remote(), timeout=10)
                self._replica_seen_healthy.add(aid)
                return True
            except Exception:
                return False

        async with self._reconcile_lock:
            for name, spec in list(self.deployments.items()):
                reps = self.replicas.setdefault(name, [])
                before = [r._actor_id for r in reps]
                target = self.targets.get(name, spec.num_replicas)
                # Probe health in parallel; kill-and-replace failures (a
                # merely dropped replica would keep running and leak its
                # resource reservation).
                oks = await asyncio.gather(*[probe(r) for r in reps])
                for r, ok in zip(list(reps), oks):
                    if not ok:
                        logger.warning("serve: replica of %s unhealthy, "
                                       "replacing", name)
                        await self._kill_replica(r)
                reps[:] = [r for r, ok in zip(reps, oks) if ok]
                while len(reps) < target:
                    reps.append(await self._create_replica(name, spec))
                victims = []
                while len(reps) > target:
                    victims.append(reps.pop())
                if [r._actor_id for r in reps] != before:
                    self._bump_version(name)   # before draining victims
                for v in victims:
                    await self._kill_replica(v)

    async def _autoscale(self):
        """Queue-depth autoscaling (reference: autoscaling_policy.py:93)."""
        for name, spec in list(self.deployments.items()):
            cfg = spec.autoscaling
            reps = self.replicas.get(name, [])
            if not cfg or not reps:
                continue
            try:
                qs = await asyncio.gather(
                    *[asyncio.wait_for(r.queue_len.remote(), timeout=10)
                      for r in reps])
            except Exception:
                continue
            mean_q = sum(qs) / len(qs)
            hist = self._metrics.setdefault(name, [])
            hist.append(mean_q)
            del hist[:-5]
            target_q = cfg.get("target_queue_len", 2.0)
            lo = cfg.get("min_replicas", 1)
            hi = cfg.get("max_replicas", spec.num_replicas)
            cur = self.targets.get(name, len(reps))
            smoothed = sum(hist) / len(hist)
            if smoothed > target_q and cur < hi:
                self.targets[name] = min(hi, cur + 1)
                logger.info("serve: scaling %s up to %d (queue %.1f)",
                            name, self.targets[name], smoothed)
            elif smoothed < 0.5 * target_q and cur > lo and len(hist) >= 5:
                self.targets[name] = max(lo, cur - 1)
                logger.info("serve: scaling %s down to %d (queue %.1f)",
                            name, self.targets[name], smoothed)
