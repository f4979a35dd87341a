"""A traced window on the card (``torch.profiler``, CUPTI) and its reduction
to what the per-layer readers take: busy seconds (the union of the kernels'
intervals), seconds by kernel class (``data/kernel_classes.json``), the
device operations that took most time, and the idle gaps by what the host
was doing when each began (the innermost host event open at its start).

A trace that lost records (a kernel launched on the host before the last
0.3 s of the window with no kernel on the device) says so on standard error
and gives nothing: no device metric is read from it.
"""

from __future__ import annotations

import heapq
import json
import os
import sys
from typing import Dict, List, Optional

WINDOW_MARK = "perfbench.traced_window"
_LAUNCH = ("cudaLaunch", "cuLaunch")
# Launches made this close to the window's end by another thread (the
# engine's executor) may run after the profiler stops: only earlier ones
# must have their kernel in the trace.
LAUNCH_MARGIN_NS = 300_000_000
_HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_classes() -> List:
    with open(os.path.join(_HERE, "data", "kernel_classes.json")) as f:
        return json.load(f)["classes"]


def classify(name: str, classes) -> str:
    return next((c for c, words in classes if any(w in name for w in words)),
                "other")


class Window:
    """``start()`` ... ``stop()`` around the work to trace; ``stop``
    returns the reduction, or None when the trace lost records."""

    def __init__(self, top: int = 10):
        self.top = top
        self._prof = self._mark = None

    def start(self) -> None:
        """Start the profiler; the traced window opens at ``open()``, so
        that work run between the two takes the profiler's first-use cost
        outside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()

    def open(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()

    def stop(self) -> Optional[Dict]:
        import torch
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce_events(events, self.top)


def reduce_events(events, top: int = 10) -> Optional[Dict]:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, launches = [], [], []
    window = None
    for e in events:
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            # Annotations (the window's, the optimizer's) are copied onto
            # the device's timeline; they are not device work.
            if not e.is_user_annotation() and name != WINDOW_MARK:
                kernels.append((start, end, name, e.correlation_id()))
        elif name == WINDOW_MARK:
            window = (start, end)
        else:
            host.append((start, end, name))
            if name.startswith(_LAUNCH):
                launches.append((start, e.correlation_id()))
    done = {k[3] for k in kernels}
    lost = sum(1 for t, c in launches
               if window and t < window[1] - LAUNCH_MARGIN_NS
               and c not in done)
    if window is None or not kernels or lost:
        print(f"perfbench: the trace lost records ({lost} of {len(launches)}"
              f" launches without a kernel, {len(kernels)} kernels, window "
              f"{'found' if window else 'missing'}): no device metric is "
              f"read from it", file=sys.stderr)
        return None
    w0, w1 = window
    classes = kernel_classes()
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    spans = []
    for start, end, name, _ in kernels:
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        s = (end - start) / 1e9
        cls = classify(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + s
        by_name[name] = by_name.get(name, 0.0) + s
        spans.append((start, end))
    spans.sort()
    busy, gaps, cursor = 0, [], w0
    for start, end in spans:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": len(spans),
        "launches": len(launches),
        "by_class": by_class,
        "device_ops": _top(by_name, top),
        "idle_gaps": _top(_gaps_by_host(gaps, host), top),
    }


def _top(by_name: Dict[str, float], n: int) -> List:
    return [[k[:120], v] for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:n]]


def _gaps_by_host(gaps, host) -> Dict[str, float]:
    """Seconds of idle gaps by the innermost host event open at each gap's
    start (latest start among those open), ``(none)`` where none was."""
    host = sorted(host)
    out: Dict[str, float] = {}
    heap: List = []
    i = 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] <= g0:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] <= g0:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(none)"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out
