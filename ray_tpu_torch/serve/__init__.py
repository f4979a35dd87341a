"""ray_tpu_torch.serve — online model serving.

Reference analogs: ``python/ray/serve/`` — ``serve.run`` (api.py:455),
``@serve.deployment`` (deployment.py), ServeController reconciliation
(controller.py:64, _private/deployment_state.py:1769), queue-aware router
(_private/router.py:261), micro-batching (serve/batching.py), HTTP proxy
(_private/http_proxy.py:387).

GPU shape: replicas are actors whose handlers typically close over a model
forward on the card — one replica per card (``ray_actor_options=
{"num_gpus": 1}``: the raylet names the leased card in the replica's
``CUDA_VISIBLE_DEVICES``).  The controller reconciles declared deployments
to replica actors; routing is client-side least-outstanding over the
replica set with a cached view refreshed from the controller.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME, ServeController,
                                      DeploymentSpec)
from ray_tpu_torch.serve.router import DeploymentHandle

__all__ = ["deployment", "run", "get_handle", "delete", "shutdown",
           "batch", "status", "start_http", "rolling_restart"]


class Deployment:
    """Declarative deployment wrapper produced by @serve.deployment."""

    def __init__(self, cls_or_fn, name, config):
        self._callable = cls_or_fn
        self.name = name
        self.config = config
        self._init_args: tuple = ()
        self._init_kwargs: dict = {}

    def options(self, **kw) -> "Deployment":
        d = Deployment(self._callable, kw.pop("name", self.name),
                       {**self.config, **kw})
        d._init_args, d._init_kwargs = self._init_args, self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        d = Deployment(self._callable, self.name, dict(self.config))
        d._init_args, d._init_kwargs = args, kwargs
        return d

    def _spec(self) -> DeploymentSpec:
        from ray_tpu_torch._private import cloudpickle
        from ray_tpu_torch.remote_function import _build_resources
        actor_options = self.config.get("ray_actor_options", {})
        # num_gpus=k: k whole cards a replica, named in its
        # CUDA_VISIBLE_DEVICES by the raylet (checked whole here).
        resources = _build_resources({
            "resources": actor_options.get("resources"),
            "num_gpus": actor_options.get("num_gpus")}) or None
        return DeploymentSpec(
            name=self.name,
            callable_blob=cloudpickle.dumps(
                (self._callable, self._init_args, self._init_kwargs)),
            num_replicas=self.config.get("num_replicas", 1),
            max_concurrent_queries=self.config.get(
                "max_concurrent_queries", 8),
            route_prefix=self.config.get("route_prefix",
                                         f"/{self.name}"),
            resources=resources,
            num_cpus=actor_options.get("num_cpus", 1.0),
            autoscaling=self.config.get("autoscaling_config"),
            user_config=self.config.get("user_config"),
            runtime_env=actor_options.get("runtime_env"),
        )


def deployment(cls_or_fn=None, *, name: Optional[str] = None, **config):
    """Decorator declaring a deployment (reference: serve/deployment.py)."""
    def wrap(target):
        return Deployment(target, name or target.__name__, config)
    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


def _controller() -> "ray_tpu_torch.actor.ActorHandle":
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        actor_cls = ray_tpu_torch.remote(ServeController)
        # Generous concurrency: every live DeploymentHandle keeps one
        # listen_for_change long-poll PARKED in a slot (reference
        # LongPollHost is slot-free only because Serve's controller is
        # asyncio-unbounded); parked polls cost memory, not CPU.
        return actor_cls.options(name=CONTROLLER_NAME, lifetime="detached",
                                 get_if_exists=True, num_cpus=0.1,
                                 max_restarts=-1,
                                 max_concurrency=512).remote()


def run(target: Deployment, *, _blocking: bool = True) -> DeploymentHandle:
    """Deploy (create or update) and return a handle.

    Deployment graphs (reference: serve/dag.py + deployment_graph_build):
    a Deployment bound as another deployment's init arg is deployed first
    and replaced by its DeploymentHandle, so composed models call each
    other through the router (`self.upstream.remote(x)`)."""
    import copy

    def _has_dep(v) -> bool:
        if isinstance(v, Deployment):
            return True
        if isinstance(v, (list, tuple)):
            return any(_has_dep(x) for x in v)
        if isinstance(v, dict):
            return any(_has_dep(x) for x in v.values())
        return False

    def _materialize(v):
        # Recurse through containers: a Deployment nested in a list/dict
        # init arg must still be deployed and replaced by its handle —
        # silently pickling the raw Deployment into the replica would only
        # fail at first request time.  Containers WITHOUT a nested
        # Deployment pass through untouched (rebuilding would break tuple
        # subclasses and drop dict-subclass state like default factories).
        if isinstance(v, Deployment):
            return run(v, _blocking=_blocking)
        if not _has_dep(v):
            return v
        if isinstance(v, tuple):
            items = [_materialize(x) for x in v]
            return (v._replace(**dict(zip(v._fields, items)))
                    if hasattr(v, "_fields") else tuple(items))
        if isinstance(v, (list, dict)):
            c = copy.copy(v)   # preserves subclass + its extra state
            if isinstance(c, list):
                for i, x in enumerate(c):
                    c[i] = _materialize(x)
            else:
                for k in list(c):
                    c[k] = _materialize(c[k])
            return c
        return v

    if any(_has_dep(v) for v in (*target._init_args,
                                 *target._init_kwargs.values())):
        target = target.bind(
            *[_materialize(a) for a in target._init_args],
            **{k: _materialize(v)
               for k, v in target._init_kwargs.items()})
    ctrl = _controller()
    ray_tpu_torch.get(ctrl.deploy.remote(target._spec()))
    if _blocking:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = ray_tpu_torch.get(ctrl.status.remote())
            d = st.get(target.name)
            if d and d["running"] >= d["target"]:
                break
            time.sleep(0.2)
        else:
            raise TimeoutError(
                f"deployment {target.name} did not become ready")
    return get_handle(target.name)


def get_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _controller())


def status() -> Dict[str, Any]:
    return ray_tpu_torch.get(_controller().status.remote())


def delete(name: str):
    ray_tpu_torch.get(_controller().delete_deployment.remote(name))


def rolling_restart(name: str) -> Dict[str, Any]:
    """Replace every replica of ``name`` one at a time with zero dropped
    streams: surge-create the replacement, stop routing to the victim
    (long-poll push), drain it (RT_SERVE_DRAIN_S), then kill it —
    stragglers complete via the ingress's mid-stream failover.  Returns
    ``{"deployment", "replaced", "skipped"}``."""
    return ray_tpu_torch.get(_controller().rolling_restart.remote(name),
                       timeout=600)


def start_http(host: str = "127.0.0.1", port: int = 0,
               per_node: bool = False) -> str:
    """Start the HTTP ingress; returns the first ingress's base URL.

    Reference: one ``HTTPProxyActor`` per node (http_proxy.py:387) so no
    single actor is a serving bottleneck or SPOF.  ``per_node=True``
    starts one ingress pinned to every alive node (named
    ``_serve_http:<node12>``); ``http_addresses()`` lists them all.  Each
    ingress keeps its own long-poll-refreshed route table, so any of them
    can serve any route."""
    urls = _start_ingresses(host, port, per_node)
    return urls[0]


def http_addresses() -> List[str]:
    """Base URLs of every running ingress actor (reference:
    serve.status() proxy listing)."""
    from ray_tpu_torch._private.worker import get_core
    urls = []
    named = get_core().gcs_request({"type": "list_named_actors"})
    for rec in named:
        name = rec["name"]
        if name == "_serve_http" or name.startswith("_serve_http:"):
            try:
                a = ray_tpu_torch.get_actor(name)
                h, p = ray_tpu_torch.get(a.address.remote(), timeout=30)
                urls.append(f"http://{h}:{p}")
            except Exception:
                pass
    return sorted(urls)


def _wait_name_free(name: str, core, timeout: float = 30.0) -> bool:
    """Block until a detached-actor name is free in the GCS.

    ``get_named_actor`` already filters DEAD actors, so the name is free
    as soon as the kill lands.  Returns False on timeout (callers proceed
    anyway — the retry then fails loudly instead of silently hanging)."""
    from ray_tpu_torch._private.worker import global_worker
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            rec = core.gcs_request({"type": "get_named_actor",
                                    "name": name,
                                    "namespace": global_worker.namespace})
        except Exception:
            return True     # GCS gone — nothing to conflict with
        if rec is None:
            return True
        time.sleep(0.1)
    return False


def _start_ingresses(host: str, port: int, per_node: bool) -> List[str]:
    from ray_tpu_torch._private.worker import get_core, global_worker
    from ray_tpu_torch.serve.http_ingress import HTTPIngress
    _controller()  # make sure the controller exists for route refresh
    ingress_cls = ray_tpu_torch.remote(HTTPIngress)
    targets: List[tuple] = [("_serve_http", None)]
    if per_node:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        nodes = get_core().gcs_request({"type": "get_nodes"})
        targets = [(f"_serve_http:{n['node_id'][:12]}",
                    NodeAffinitySchedulingStrategy(n["node_id"]))
                   for n in nodes if n["alive"]]
    urls = []
    for name, strategy in targets:
        # Every node's ingress tries the requested port (on real
        # multi-host clusters the binds are on distinct hosts).  Only on
        # an actual bind conflict — simulated clusters share one host —
        # does that node's ingress fall back to an ephemeral port.
        addr = None
        last_err: Optional[Exception] = None
        for node_port in ((port,) if port == 0 else (port, 0)):
            ingress = ingress_cls.options(
                name=name, lifetime="detached", get_if_exists=True,
                num_cpus=0, max_concurrency=64,
                scheduling_strategy=strategy).remote(
                host, node_port, global_worker.namespace)
            try:
                addr = ray_tpu_torch.get(ingress.address.remote(), timeout=60)
                break
            except Exception as e:
                # a bind conflict surfaces as a wrapped TaskError(OSError)
                # — retry once on an ephemeral port; anything that also
                # fails the retry propagates below
                last_err = e
                ray_tpu_torch.kill(ingress)
                # kill() is async on the GCS side: until the DEAD state
                # lands, get_if_exists on the retry would hand back the
                # DYING actor and the ephemeral-port attempt would time
                # out against it.  Wait for the name to actually free.
                _wait_name_free(name, get_core(), timeout=30)
        if addr is None:
            raise RuntimeError(
                f"serve ingress {name} failed to start") from last_err
        urls.append(f"http://{addr[0]}:{addr[1]}")
    return urls


def shutdown():
    """Tear down all deployments, the controller, and the ingress."""
    from ray_tpu_torch._private.worker import get_core
    fleet = []
    try:
        fleet = [r["name"] for r in
                 get_core().gcs_request({"type": "list_named_actors"})
                 if r["name"].startswith("_serve_http:")]
    except Exception:
        pass
    for actor_name in (*fleet, "_serve_http", CONTROLLER_NAME):
        try:
            a = ray_tpu_torch.get_actor(actor_name)
            if actor_name == CONTROLLER_NAME:
                try:
                    ray_tpu_torch.get(a.shutdown.remote(), timeout=30)
                except Exception:
                    pass
            ray_tpu_torch.kill(a)
        except Exception:
            pass

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("serve")
del _rlu
