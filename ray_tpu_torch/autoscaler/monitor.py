"""Autoscaler monitor loop.

Port of ``ray_tpu/autoscaler/monitor.py``.

Design analog: reference ``autoscaler/_private/monitor.py:126`` -- a head-node
process that reads load from the GCS and drives StandardAutoscaler.update()
on a period.  Here it runs as a daemon thread in the process that owns the
provider (the driver or the head daemon), reading load through the connected
worker's GCS channel.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalerConfig,
                                                 StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


class Monitor:
    def __init__(self, provider: NodeProvider, config: AutoscalerConfig,
                 update_interval_s: float = 1.0,
                 load_source=None):
        if load_source is None:
            def load_source():
                from ray_tpu_torch._private.worker import get_core
                return get_core().gcs_request({"type": "get_load_metrics"})
        self.autoscaler = StandardAutoscaler(provider, config, load_source)
        self.update_interval_s = update_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rt-autoscaler-monitor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _run(self):
        while not self._stop.wait(self.update_interval_s):
            try:
                self.autoscaler.update()
            except Exception:
                logger.exception("autoscaler update failed")
