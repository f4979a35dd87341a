"""Proactive object replication: 1->N tree broadcast through the raylets.

Design analog: reference ``src/ray/object_manager/push_manager.h:29``
(owner-initiated chunked push with in-flight caps) — extended with a
binomial-tree fan-out the reference lacks: BASELINE.md's 1 GiB -> 50-node
broadcast is a pull storm there (every node pulls from the one holder);
here each link carries the object once and the rounds are O(log N).

    ref = ray_tpu_torch.put(big_array)
    ray_tpu_torch.util.broadcast(ref)        # all alive nodes now hold a copy

After the broadcast, tasks scheduled anywhere read the object from their
node-local plasma (locality-aware leasing already prefers those nodes).
"""

from __future__ import annotations

from ray_tpu_torch._private.worker import get_core


def broadcast(ref, timeout: float = 300) -> int:
    """Replicate ``ref``'s plasma object to every alive node.

    Returns the number of nodes pushed to (0 for inline objects, which
    travel with their ObjectRef anyway).  Blocks until the tree completes;
    raises if any relay failed.
    """
    return get_core().broadcast_object(ref, timeout=timeout)
