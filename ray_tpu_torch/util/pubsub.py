"""Cluster event pubsub.

Design analog: reference ``src/ray/pubsub/`` (Publisher:298 / Subscriber) --
GCS-hosted channels pushing node/actor lifecycle events to subscribed
processes over their existing GCS connection (no extra sockets, matching the
reference's long-poll-over-gRPC design in spirit).

Channels currently published by the GCS: ``"nodes"`` ({event:
alive|disconnected|reconnected|dead, node: {...}}) and ``"actors"``
({event: alive|restarting|dead, actor: {...}}).

Subscriptions survive control-plane partitions: the GCS tracks
subscribers per connection, and the core worker's reconnecting GCS
connection replays every active channel subscription after a drop
(see CoreWorker._on_gcs_reconnect), so callbacks resume without caller
involvement.  Events published while the link was down are NOT
replayed — subscribers needing a complete history must reconcile from
authoritative state (e.g. ``util.state.list_nodes``) on reconnect.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def subscribe(channel: str, callback: Callable[[Dict[str, Any]], None]):
    """Register callback(data) for events on channel. Runs on a background
    thread; keep it fast and non-blocking."""
    from ray_tpu_torch._private.worker import get_core
    get_core().subscribe(channel, callback)


def unsubscribe(channel: str, callback=None):
    from ray_tpu_torch._private.worker import get_core
    get_core().unsubscribe(channel, callback)
