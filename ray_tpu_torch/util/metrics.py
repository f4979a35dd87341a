"""User-facing metrics API: Counter, Gauge, Histogram.

Reference analog: ``python/ray/util/metrics.py`` (Counter:155, Gauge:295,
Histogram:220) — metrics defined in any driver/worker process, exported via
a background flusher to the GCS (the reference exports via OpenCensus to a
per-node metrics agent; the control plane differs, the user API matches).

Aggregation at read time: counters sum across processes, gauges are
last-write, histogram bucket counts sum.  ``collect()`` returns aggregated
metrics; ``prometheus_text()`` renders the standard exposition format.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: List["Metric"] = []
_reg_lock = threading.Lock()
_flusher: Optional[threading.Thread] = None
FLUSH_PERIOD_S = 1.0


def _ensure_flusher():
    global _flusher
    with _reg_lock:
        if _flusher is not None and _flusher.is_alive():
            return

        def run():
            while True:
                time.sleep(FLUSH_PERIOD_S)
                try:
                    flush()
                except Exception:
                    pass

        _flusher = threading.Thread(target=run, daemon=True,
                                    name="rt-metrics-flush")
        _flusher.start()


def flush():
    """Push every registered metric's current state to the GCS."""
    import os

    from ray_tpu_torch._private.worker import global_worker
    if not global_worker.connected:
        return
    with _reg_lock:
        snap = [m._snapshot() for m in _REGISTRY]
    payload = [s for group in snap for s in group]
    if payload:
        global_worker.core_worker.gcs_request(
            {"type": "report_metrics", "metrics": payload,
             "pid": os.getpid()})


class Metric:
    _type = "?"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._series: Dict[Tuple, dict] = {}
        self._lock = threading.Lock()
        with _reg_lock:
            _REGISTRY.append(self)
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]):
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _cell(self, tags):
        key = self._key(tags)
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = {"value": 0.0, "buckets": None}
        return cell

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [{"name": self.name, "type": self._type,
                     "labels": dict(k), "value": c["value"],
                     "buckets": dict(c["buckets"]) if c["buckets"] else None,
                     "description": self.description}
                    for k, c in self._series.items()]


class Counter(Metric):
    _type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        with self._lock:
            self._cell(tags)["value"] += value


class Gauge(Metric):
    _type = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._cell(tags)["value"] = float(value)


class Histogram(Metric):
    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [0.1, 1.0, 10.0]

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            cell = self._cell(tags)
            if cell["buckets"] is None:
                cell["buckets"] = {str(b): 0 for b in self.boundaries}
                cell["buckets"]["+Inf"] = 0
            idx = bisect.bisect_left(self.boundaries, value)
            label = (str(self.boundaries[idx])
                     if idx < len(self.boundaries) else "+Inf")
            cell["buckets"][label] += 1
            cell["value"] += 1  # observation count


def collect() -> List[dict]:
    """Aggregated cluster-wide metrics from the GCS."""
    from ray_tpu_torch._private.worker import get_core
    flush()
    return get_core().gcs_request({"type": "list_metrics"})


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _sanitize_name(n: str) -> str:
    """Prometheus metric-name charset [a-zA-Z0-9_:]; applied in ONE place
    so every exposition endpoint (dashboard, prometheus_text) emits the
    same series name for the same metric."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in n)


def render_prometheus(metrics: List[dict],
                      prefix: str = "ray_tpu_user_") -> str:
    """Prometheus text exposition of pre-aggregated metric records
    (pure rendering — usable from the GCS-hosted dashboard where no
    connected worker exists).  The shared default prefix namespaces user
    metrics away from built-in ray_tpu_* series identically on every
    exposition endpoint."""
    lines = []
    for m in metrics:
        m = {**m, "name": prefix + _sanitize_name(m["name"])}
        labels = ",".join(f'{k}="{_escape_label(v)}"' for k, v in
                          sorted(m["labels"].items()))
        lab = f"{{{labels}}}" if labels else ""
        if m["type"] == "histogram" and m.get("buckets"):
            # Prometheus le= buckets are CUMULATIVE with +Inf == _count.
            def bkey(b):
                return float("inf") if b == "+Inf" else float(b)
            running = 0
            for b in sorted(m["buckets"], key=bkey):
                running += m["buckets"][b]
                bl = (labels + "," if labels else "") + f'le="{b}"'
                lines.append(f"{m['name']}_bucket{{{bl}}} {running}")
            lines.append(f"{m['name']}_count{lab} {m['value']}")
        else:
            lines.append(f"{m['name']}{lab} {m['value']}")
    return "\n".join(lines) + "\n"


def prometheus_text() -> str:
    """Standard Prometheus exposition of the aggregated metrics."""
    return render_prometheus(collect())
