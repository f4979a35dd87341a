"""Local mode: tasks and actors execute inline in the driver process.

Design analog: reference ``ray.init(local_mode=True)`` (LocalModeManager
era semantics): no daemons, no workers — ``.remote()`` runs the function
synchronously and returns an already-resolved ref.  For debugging with
pdb/print; the scheduling/resource model is intentionally absent (same
limitation as the reference).  Cluster-only surfaces (placement groups,
GCS KV, dashboards, libraries that spawn daemons) are unsupported here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef, ObjectRefGenerator


class LocalModeCore:
    """Duck-typed CoreWorker subset backing the public API inline."""

    def __init__(self):
        self._store: Dict[str, Any] = {}       # hex -> ("val"|"err", value)
        self._actors: Dict[str, Any] = {}      # actor_id hex -> instance
        self._named: Dict[tuple, str] = {}     # (ns, name) -> actor_id
        self._method_meta: Dict[str, dict] = {}  # actor_id -> {meth: n_ret}
        self.address = "local"
        self.node_id_hex = "local0" * 4 + "beef"
        self.job_id = "local"
        self.is_worker = False
        self.task_executor = None

    # -- objects ----------------------------------------------------------
    def _ref_for(self, value, is_error: bool = False) -> ObjectRef:
        oid = ObjectID.from_random()
        self._store[oid.hex()] = ("err" if is_error else "val", value)
        return ObjectRef(oid, self.address)

    def put(self, value: Any) -> ObjectRef:
        return self._ref_for(value)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        out = []
        for r in refs:
            kind, v = self._store[r.hex()]
            if kind == "err":
                raise v
            out.append(v)
        return out

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        return list(refs[:num_returns]), list(refs[num_returns:])

    # -- tasks ------------------------------------------------------------
    def submit_task(self, func, args, kwargs, *, num_returns=1,
                    **_) -> List[ObjectRef]:
        args = [self.get([a])[0] if isinstance(a, ObjectRef) else a
                for a in args]
        kwargs = {k: self.get([v])[0] if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        try:
            result = func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - stored, raised at get()
            return self._error_refs(e, num_returns)
        if num_returns == "dynamic":
            return [self._ref_for(ObjectRefGenerator(
                [self._ref_for(v) for v in result]))]
        if num_returns == 1:
            return [self._ref_for(result)]
        results = list(result)
        if len(results) != num_returns:
            raise ValueError(f"task declared num_returns={num_returns} "
                             f"but returned {len(results)}")
        return [self._ref_for(v) for v in results]

    # -- actors -----------------------------------------------------------
    def create_actor(self, cls, args, kwargs, *, name=None,
                     namespace="default", get_if_exists=False,
                     method_meta=None, **_) -> str:
        if name and (namespace, name) in self._named:
            if get_if_exists:
                return self._named[(namespace, name)]
            raise ValueError(f"actor name {name!r} already taken")
        aid = ActorID.from_random().hex()
        self._actors[aid] = cls(*args, **kwargs)
        self._method_meta[aid] = dict(method_meta or {})
        if name:
            self._named[(namespace, name)] = aid
        return aid

    def _error_refs(self, exc, num_returns) -> List[ObjectRef]:
        """Mirror cluster-mode arity: `a, b = f.remote()` must unpack at
        submission and surface the error at get() — n DISTINCT refs (same
        identity semantics as cluster return ids), each holding the
        exception."""
        n = 1 if num_returns == "dynamic" else num_returns
        return [self._ref_for(exc, is_error=True) for _ in range(n)]

    def submit_actor_task(self, actor_id_hex, method, args, kwargs, *,
                          num_returns=1, **_) -> List[ObjectRef]:
        inst = self._actors.get(actor_id_hex)
        if inst is None:
            from ray_tpu_torch import exceptions as rex
            return self._error_refs(
                rex.ActorDiedError(f"actor {actor_id_hex[:12]} is dead"),
                num_returns)
        bound = getattr(inst, method)
        return self.submit_task(bound, args, kwargs,
                                num_returns=num_returns)

    def kill_actor(self, actor_id_hex: str, no_restart: bool = True):
        self._actors.pop(actor_id_hex, None)
        for key, aid in list(self._named.items()):
            if aid == actor_id_hex:
                del self._named[key]

    def kill_actor_nowait(self, actor_id_hex: str):
        self.kill_actor(actor_id_hex)

    def get_named_actor(self, name: str, namespace: str = "default"):
        aid = self._named.get((namespace, name))
        if not aid:
            return None
        return {"actor_id": aid, "class_name": "Actor",
                "method_meta": self._method_meta.get(aid, {})}

    # -- misc surface used by utilities -----------------------------------
    def cluster_resources(self) -> Dict[str, float]:
        import os
        return {"CPU": float(os.cpu_count() or 1)}

    available_resources = cluster_resources

    def nodes(self) -> List[dict]:
        return [{"node_id": self.node_id_hex, "alive": True,
                 "resources": self.cluster_resources()}]

    def record_task_event(self, *_a, **_k):
        pass

    def gcs_request(self, msg: dict, timeout=None):
        raise RuntimeError(
            f"local_mode has no GCS (request {msg.get('type')!r}); "
            f"use a real cluster for this feature")

    def shutdown(self):
        self._store.clear()
        self._actors.clear()

    def connection_info(self) -> dict:
        return {"address": "local", "local_mode": True,
                "started_at": time.time()}
