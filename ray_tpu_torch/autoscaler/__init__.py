"""Elastic cluster scaling.

Port of ``ray_tpu/autoscaler/__init__.py``.

Design analog: reference ``python/ray/autoscaler/_private/`` --
StandardAutoscaler (autoscaler.py:167), ResourceDemandScheduler
(resource_demand_scheduler.py:103), Monitor (monitor.py:126), NodeProvider
(autoscaler/node_provider.py:13).

The scaling unit is a *node type* that may be a whole group of GPU hosts
on one interconnect (all hosts of a group come and go together -- a group
is atomic, unlike the reference's per-VM granularity).
"""

from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,
                                                    NodeTypeConfig,
                                                    LocalNodeProvider)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    ResourceDemandScheduler, fits, subtract)
from ray_tpu_torch.autoscaler.autoscaler import (StandardAutoscaler,
                                                 AutoscalerConfig)
from ray_tpu_torch.autoscaler.monitor import Monitor

__all__ = [
    "NodeProvider", "NodeTypeConfig", "LocalNodeProvider",
    "ResourceDemandScheduler", "StandardAutoscaler", "AutoscalerConfig",
    "Monitor", "fits", "subtract",
]
