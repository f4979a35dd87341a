from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util.object_broadcast import broadcast  # noqa: F401
from ray_tpu_torch.util import rpdb  # noqa: F401  (ray.util.rpdb analog)
