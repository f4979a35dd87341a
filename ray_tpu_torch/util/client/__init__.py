"""Ray Client: remote drivers through a proxy with per-client sessions.

Port of ``ray_tpu/util/client/__init__.py``.

Design analog: reference ``python/ray/util/client/server/proxier.py`` —
a public proxy endpoint that spawns one ISOLATED server process per
connecting client (own driver identity, own object ownership), routes
that client's traffic to it, supports reconnect within a grace period,
and reaps the session when the client is gone.

Two access styles coexist:
  * ``ray_tpu_torch.init("ray://<gcs>")`` — the in-repo thin client: the
    calling process IS the driver over TCP (good on trusted networks).
  * ``ray_tpu_torch.util.client.connect("<proxy_host:port>")`` — this module:
    the driver runs server-side in a per-client session process; the
    client speaks a compact op protocol (put/get/task/actor).  Refs stay
    valid across client reconnects because their OWNER is the session
    process, which outlives the TCP connection.
"""

from ray_tpu_torch.util.client.client import ClientContext, connect
from ray_tpu_torch.util.client.proxy import ClientProxyServer, start_proxy

__all__ = ["ClientContext", "ClientProxyServer", "connect", "start_proxy"]
