"""Internal KV convenience API over the GCS KV tables.

Design analog: reference ``ray.experimental.internal_kv``
(``_private/gcs_utils.py`` internal_kv_put/get/del/keys) -- used by job
submission, runtime_env packaging, and library metadata.
"""

from __future__ import annotations

from typing import List, Optional


def _gcs(msg: dict):
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request(msg)


def kv_put(key: bytes, value: bytes, *, ns: str = "",
           overwrite: bool = True) -> bool:
    return _gcs({"type": "kv_put", "ns": ns, "key": key, "value": value,
                 "overwrite": overwrite})


def kv_get(key: bytes, *, ns: str = "") -> Optional[bytes]:
    return _gcs({"type": "kv_get", "ns": ns, "key": key})


def kv_del(key: bytes, *, ns: str = "") -> bool:
    return _gcs({"type": "kv_del", "ns": ns, "key": key})


def kv_keys(prefix: bytes = b"", *, ns: str = "") -> List[bytes]:
    return _gcs({"type": "kv_keys", "ns": ns, "prefix": prefix})


def kv_exists(key: bytes, *, ns: str = "") -> bool:
    return _gcs({"type": "kv_exists", "ns": ns, "key": key})
