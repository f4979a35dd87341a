"""Chunked object fetch over the raylet fetch_object protocol, plus the
data-plane integrity primitives shared by every byte path.

One shared implementation of the first-chunk-sizing / offset-advance /
truncation-handling loop, used by both the raylet's node-to-node pull and
the client-mode direct byte fetch (they had drifted apart and both carried
an empty-chunk infinite-loop hazard).

Integrity model: the object's creator stamps a crc32 at seal time and
registers it with the GCS object directory; every consumer of a full copy
(pull completion, push assembly, spill restore) re-computes the crc before
sealing and raises :class:`ChecksumError` on mismatch so the caller can
quarantine that copy and fall through to the next one instead of sealing
garbage.  Spill files carry the same crc in a fixed header so a torn or
bit-rotted file is detected even when the GCS entry predates the checksum
(or is gone).  crc32 (zlib, stdlib) rather than crc32c/xxhash: no new
dependencies, and at transfer-chunk granularity the cost is noise next to
the copy itself.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Awaitable, Callable, Iterable, Optional, Tuple


class ChecksumError(Exception):
    """Bytes do not match their seal-time checksum (or a spill file is
    torn).  Distinct from a truncated/aborted transfer so callers can
    quarantine the offending copy rather than merely retry it."""


def crc32_bytes(buf) -> int:
    """crc32 of one bytes-like object (memoryview/bytearray/bytes)."""
    return zlib.crc32(buf) & 0xFFFFFFFF


def crc32_segments(segments: Iterable) -> int:
    """crc32 over concatenated segments without materializing the join
    (matches crc32_bytes of the plasma copy, which IS the concatenation)."""
    crc = 0
    for seg in segments:
        crc = zlib.crc32(seg, crc)
    return crc & 0xFFFFFFFF


# -- spill file format ----------------------------------------------------
#
# | magic "RTSPILL1" (8) | payload size u64 LE | crc32 u32 LE | payload |
#
# The header makes a spill file self-verifying: restore and remote fetch
# both know the true payload length (a truncated file cannot silently
# serve short reads as EOF) and the expected crc.  Files without the magic
# are served headerless for compatibility with pre-header spills.

SPILL_MAGIC = b"RTSPILL1"
_SPILL_HEADER = struct.Struct("<8sQI")
SPILL_HEADER_SIZE = _SPILL_HEADER.size


def pack_spill_header(payload_size: int, checksum: int) -> bytes:
    return _SPILL_HEADER.pack(SPILL_MAGIC, payload_size, checksum)


def unpack_spill_header(raw: bytes) -> Optional[Tuple[int, int]]:
    """(payload_size, crc32) from a header blob, or None when the blob is
    not a spill header (legacy headerless file)."""
    if len(raw) < SPILL_HEADER_SIZE:
        return None
    magic, size, crc = _SPILL_HEADER.unpack(raw[:SPILL_HEADER_SIZE])
    if magic != SPILL_MAGIC:
        return None
    return size, crc


def write_spill_file(path: str, data, do_fsync: bool = True
                     ) -> Tuple[int, float]:
    """Write ``data`` to ``path`` with the integrity header, atomically and
    durably: tmp file -> fsync(file) -> rename -> fsync(dir).  A crash at
    any point leaves either the previous state or a complete, verifiable
    file — never a torn one that a later restore would seal into plasma.
    Returns (crc32, seconds spent in fsync)."""
    crc = crc32_bytes(data)
    tmp = path + ".tmp"
    fsync_s = 0.0
    with open(tmp, "wb") as f:
        f.write(pack_spill_header(len(data), crc))
        f.write(data)
        if do_fsync:
            f.flush()
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            fsync_s += time.perf_counter() - t0
    os.replace(tmp, path)
    if do_fsync:
        # The rename itself must be durable: without the directory fsync a
        # crash can keep the (fsynced) inode but lose the directory entry.
        t0 = time.perf_counter()
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        fsync_s += time.perf_counter() - t0
    return crc, fsync_s


def read_spill_file(path: str, verify: bool = True
                    ) -> Tuple[bytes, Optional[int]]:
    """Read a spill file's payload; returns (payload, stored crc or None
    for legacy headerless files).  Raises ChecksumError when the payload
    is shorter than the header claims (torn write / truncation) or, with
    ``verify``, when the crc does not match."""
    with open(path, "rb") as f:
        head = f.read(SPILL_HEADER_SIZE)
        parsed = unpack_spill_header(head)
        if parsed is None:
            return head + f.read(), None
        size, crc = parsed
        data = f.read(size)
    if len(data) != size:
        raise ChecksumError(
            f"spill file {path} truncated: {len(data)} of {size} bytes")
    if verify and crc32_bytes(data) != crc:
        raise ChecksumError(f"spill file {path} failed crc32 verification")
    return data, crc


def read_spill_chunk(path: str, offset: int, nbytes: int
                     ) -> Tuple[int, Optional[int], bytes]:
    """One fetch frame's worth of a spill file: (payload total, stored crc
    or None, chunk at payload offset).  Blocking — run on an executor."""
    with open(path, "rb") as f:
        head = f.read(SPILL_HEADER_SIZE)
        parsed = unpack_spill_header(head)
        if parsed is None:
            total, crc, base = os.path.getsize(path), None, 0
        else:
            (total, crc), base = parsed, SPILL_HEADER_SIZE
        f.seek(base + offset)
        data = f.read(nbytes)
    return total, crc, data


# -- transfer loops -------------------------------------------------------

async def fetch_object_into(conn, oid_hex: str,
                            allocate: Callable[[int], Awaitable],
                            timeout: float = 120,
                            checksum: Optional[int] = None
                            ) -> Optional[object]:
    """Stream an object's bytes from a peer raylet into a buffer.

    ``allocate(total)`` is awaited once with the object size and must
    return a writable buffer (memoryview/bytearray).  Returns the filled
    buffer, or None when the peer doesn't have the object or the transfer
    truncates (evicted mid-transfer, or a short spill file serving empty
    reads — an empty chunk MUST abort, not retry the same offset forever).
    The caller owns buffer cleanup on None.

    ``checksum`` is the expected seal-time crc32; when None, the holder's
    own claim (the ``checksum`` field of the first frame, present when it
    serves from a spill header) is used instead.  A complete transfer that
    fails verification raises :class:`ChecksumError` — the caller should
    quarantine that holder's copy, not just retry it.
    """
    first = await conn.request(
        {"type": "fetch_object", "object_id": oid_hex, "offset": 0},
        timeout=timeout)
    if not first.get("found"):
        return None
    total = first["total"]
    if checksum is None:
        checksum = first.get("checksum")
    buf = await allocate(total)
    data = first["data"]
    buf[0:len(data)] = data
    pos = len(data)
    while pos < total:
        chunk = await conn.request(
            {"type": "fetch_object", "object_id": oid_hex, "offset": pos},
            timeout=timeout)
        d = chunk.get("data") if chunk.get("found") else None
        if not d:
            return None
        buf[pos:pos + len(d)] = d
        pos += len(d)
    if checksum is not None and crc32_bytes(buf) != checksum:
        raise ChecksumError(
            f"object {oid_hex[:16]}: assembled bytes fail crc32 "
            f"verification (expected {checksum:#010x})")
    return buf


async def push_object_chunks(peer, oid_hex: str, view, total: int,
                             chunk_bytes: int, inflight: int,
                             timeout: float = 120,
                             checksum: Optional[int] = None,
                             src_node: Optional[str] = None) -> bool:
    """Owner/holder-initiated chunked push (reference push_manager.h:29).

    Pipelines up to ``inflight`` chunk requests per link — the cap is the
    bandwidth-admission knob: one bulk push can't bury a peer's IO loop,
    and N concurrent pushes to one node self-throttle at N*inflight
    chunks.  Returns True when the receiver acked every chunk (or already
    had the object).

    ``checksum``/``src_node`` ride in every frame so the receiver can
    verify the assembly before sealing and name the serving node when it
    invalidates a corrupt copy (frames of one push may interleave with
    another's, so first-frame-only metadata would race).
    """
    import asyncio

    sem = asyncio.Semaphore(inflight)

    async def _send(off: int):
        async with sem:
            # Slice INSIDE the cap: at most `inflight` chunk copies exist
            # at once, so sender heap stays O(inflight * chunk), not O(obj).
            data = bytes(view[off:min(off + chunk_bytes, total)])
            msg = {"type": "receive_object_chunk", "object_id": oid_hex,
                   "offset": off, "total": total, "data": data}
            if checksum is not None:
                msg["checksum"] = checksum
            if src_node is not None:
                msg["src_node"] = src_node
            return await peer.request(msg, timeout=timeout)

    replies = await asyncio.gather(
        *(_send(off) for off in range(0, max(total, 1), chunk_bytes)),
        return_exceptions=True)
    ok = True
    for r in replies:
        if isinstance(r, BaseException):
            raise r
        if r.get("done"):          # receiver already complete/had it
            return True
        ok = ok and r.get("ok", False)
    return ok
