"""Declarative Serve config: schema + deploy-from-file.

Design analog: reference ``python/ray/serve/schema.py``
(ServeApplicationSchema: pydantic models consumed by ``serve deploy`` /
the REST API) and ``serve/scripts.py`` (the serve CLI).  Simplified:
plain dataclasses validated by hand (no pydantic in the image), YAML or
JSON on disk, deployments referenced by ``import_path =
"module:attribute"`` exactly like the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

_ALLOWED_OPTIONS = ("num_replicas", "max_concurrent_queries",
                    "autoscaling_config", "user_config")


@dataclasses.dataclass
class DeploymentSchema:
    """One deployment entry of an application config."""
    name: str
    import_path: str                      # "pkg.module:deployment_obj"
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    user_config: Optional[Dict[str, Any]] = None
    init_args: tuple = ()
    init_kwargs: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeploymentSchema":
        unknown = set(d) - {f.name for f in
                            dataclasses.fields(DeploymentSchema)}
        if unknown:
            raise ValueError(f"unknown deployment config keys: "
                             f"{sorted(unknown)}")
        if "name" not in d or "import_path" not in d:
            raise ValueError("deployment config needs 'name' and "
                             "'import_path'")
        d = dict(d)
        d["init_args"] = tuple(d.get("init_args") or ())
        return DeploymentSchema(**d)


@dataclasses.dataclass
class ServeApplicationSchema:
    """Whole-application config (reference ServeApplicationSchema)."""
    deployments: List[DeploymentSchema]
    http_host: Optional[str] = None
    http_port: int = 0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeApplicationSchema":
        deps = [DeploymentSchema.from_dict(x)
                for x in d.get("deployments", [])]
        if not deps:
            raise ValueError("config has no deployments")
        names = [x.name for x in deps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate deployment names in config: "
                             f"{names}")
        return ServeApplicationSchema(
            deployments=deps, http_host=d.get("http_host"),
            http_port=int(d.get("http_port", 0)))

    @staticmethod
    def from_file(path: str) -> "ServeApplicationSchema":
        import json
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            import yaml
            return ServeApplicationSchema.from_dict(yaml.safe_load(text))
        return ServeApplicationSchema.from_dict(json.loads(text))


def _import_target(import_path: str):
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'")
    mod_name, attr = import_path.split(":", 1)
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def deploy_application(schema: ServeApplicationSchema) -> Dict[str, Any]:
    """Deploy every entry of a declarative config (reference
    ``serve deploy``).  Returns the application's status dict."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import Deployment

    for entry in schema.deployments:
        target = _import_target(entry.import_path)
        if not isinstance(target, Deployment):
            raise TypeError(
                f"{entry.import_path} resolved to {type(target).__name__}, "
                f"expected a @serve.deployment")
        opts = {k: getattr(entry, k) for k in _ALLOWED_OPTIONS
                if getattr(entry, k) is not None}
        target = target.options(name=entry.name, **opts)
        if entry.init_args or entry.init_kwargs:
            target = target.bind(*entry.init_args,
                                 **(entry.init_kwargs or {}))
        serve.run(target)
    if schema.http_host:
        serve.start_http(schema.http_host, schema.http_port)
    return serve.status()
