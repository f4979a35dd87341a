"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose ``file`` is
given in ``configs``, and a traffic mix, ``traffic/<traffic>.json``; its
limits are ``limits/<cell>.json``.  The mix names its driver,
``drivers/<driver>.py``, and each metric is read by ``metrics/<metric>.py``
(a function ``read(run) -> float | None``).  All of these lie under the
benchmark's first path, so a cell, a mix or a metric is added by adding
files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

_MODULES: Dict[str, object] = {}


@dataclasses.dataclass
class Cell:
    name: str
    base: str          # the directory of the benchmark's files
    entry: Dict        # the cell's entry in BENCHMARK.json
    config: Dict       # the configuration file
    traffic: Dict      # traffic/<traffic>.json
    limits: Dict       # limits/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = os.path.join(root, bench["paths"][0])
    return Cell(
        name=workload, base=base, entry=entry,
        config=_json(os.path.join(root, config["file"])),
        traffic=_json(os.path.join(base, "traffic",
                                   entry["traffic"] + ".json")),
        limits=_json(os.path.join(base, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def module(base: str, kind: str, name: str):
    """``<base>/<kind>/<name>.py`` loaded once by its path (a name may hold
    dots, which an import by name would read as packages)."""
    path = os.path.join(base, kind, name + ".py")
    mod = _MODULES.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{len(_MODULES)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod
