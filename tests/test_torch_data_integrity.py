"""Object data-plane integrity: checksums, durable spill files, retrying
pulls, and quarantine of corrupt copies.

Reference analogs: python/ray/tests/test_object_spilling.py (spill file
lifecycle) and the pull_manager retry loop (object_manager/pull_manager.h)
— plus the integrity layer that is new capability here: seal-time crc32
stamped in the GCS object directory, verified on every full-copy
materialization (pull completion, push assembly, spill restore), with
checksum-mismatched copies invalidated in the directory so consumers fall
through to a healthy copy instead of sealing garbage.

Most tests drive REAL Raylet/GcsServer objects in-process (no daemon
subprocesses): handlers are invoked directly, peer RPC connections are
replaced with direct-dispatch shims, which makes byte-level corruption
and mid-transfer races deterministic.  Full-cluster versions live in
test_data_chaos.py.

The port's runtime under ``test_data_integrity.py``'s cases, one for one.
"""

import asyncio
import contextlib
import os
import shutil

import pytest

from ray_tpu_torch._private import object_transfer as ot
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.gcs import GcsServer, NodeInfo, ObjectDirEntry
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch.util import fault_injection


# --------------------------------------------------------------- primitives


def test_spill_header_roundtrip(tmp_path):
    p = str(tmp_path / "o.bin")
    data = b"payload" * 1000
    crc, fsync_s = ot.write_spill_file(p, data, do_fsync=True)
    assert crc == ot.crc32_bytes(data)
    assert fsync_s >= 0.0
    assert not os.path.exists(p + ".tmp")
    payload, stored = ot.read_spill_file(p)
    assert payload == data and stored == crc
    # Chunked reads see payload offsets, not file offsets.
    total, chunk_crc, chunk = ot.read_spill_chunk(p, 7, 7)
    assert (total, chunk_crc, chunk) == (len(data), crc, b"payload")


def test_spill_file_truncation_detected(tmp_path):
    p = str(tmp_path / "o.bin")
    ot.write_spill_file(p, b"x" * 4096)
    os.truncate(p, os.path.getsize(p) - 100)
    with pytest.raises(ot.ChecksumError, match="truncated"):
        ot.read_spill_file(p)
    # Truncation is a length-integrity violation: detected even with crc
    # verification off.
    with pytest.raises(ot.ChecksumError):
        ot.read_spill_file(p, verify=False)


def test_spill_file_bitflip_detected(tmp_path):
    p = str(tmp_path / "o.bin")
    ot.write_spill_file(p, b"y" * 1024)
    with open(p, "r+b") as f:
        f.seek(ot.SPILL_HEADER_SIZE + 10)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(ot.ChecksumError, match="crc32"):
        ot.read_spill_file(p)
    # verify=False trusts lengths only — the flip passes (the knob exists
    # precisely to skip the crc pass).
    payload, _ = ot.read_spill_file(p, verify=False)
    assert len(payload) == 1024


def test_spill_file_legacy_headerless(tmp_path):
    """Pre-header spill files are still served (crc unknown -> None)."""
    p = str(tmp_path / "o.bin")
    with open(p, "wb") as f:
        f.write(b"legacy-raw-bytes")
    assert ot.read_spill_file(p) == (b"legacy-raw-bytes", None)
    total, crc, chunk = ot.read_spill_chunk(p, 0, 6)
    assert (total, crc, chunk) == (16, None, b"legacy")


def test_crc32_segments_matches_concat():
    segs = [b"a" * 10, b"bb" * 7, b"", b"ccc"]
    assert ot.crc32_segments(segs) == ot.crc32_bytes(b"".join(segs))


class _ServingConn:
    """fetch_object peer serving from a buffer, with optional tampering."""

    closed = False

    def __init__(self, data, chunk=8, corrupt=False, claim_crc=None):
        self.data = bytearray(data)
        self.chunk = chunk
        self.corrupt = corrupt
        self.claim_crc = claim_crc
        self.requests = 0

    async def request(self, msg, timeout=None):
        assert msg["type"] == "fetch_object"
        self.requests += 1
        off = msg["offset"]
        d = bytes(self.data[off:off + self.chunk])
        if self.corrupt and d:
            d = bytes([d[0] ^ 0x01]) + d[1:]
        reply = {"found": True, "total": len(self.data), "offset": off,
                 "data": d}
        if self.claim_crc is not None and off == 0:
            reply["checksum"] = self.claim_crc
        return reply


def test_fetch_object_into_verifies_checksum():
    data = os.urandom(64)
    crc = ot.crc32_bytes(data)

    async def run():
        async def alloc(total):
            return bytearray(total)

        good = await ot.fetch_object_into(_ServingConn(data), "ab" * 14,
                                          alloc, checksum=crc)
        assert bytes(good) == data
        with pytest.raises(ot.ChecksumError):
            await ot.fetch_object_into(_ServingConn(data, corrupt=True),
                                       "ab" * 14, alloc, checksum=crc)
        # No directory stamp: the holder's own first-frame claim (spill
        # header crc) is used instead.
        with pytest.raises(ot.ChecksumError):
            await ot.fetch_object_into(
                _ServingConn(data, corrupt=True, claim_crc=crc),
                "ab" * 14, alloc, checksum=None)
        # No stamp anywhere -> unverified transfer still completes.
        got = await ot.fetch_object_into(_ServingConn(data, corrupt=True),
                                         "ab" * 14, alloc, checksum=None)
        assert got is not None and bytes(got) != data

    asyncio.run(run())


# ---------------------------------------------------------- fault injection


def test_data_plane_fault_spec_parsing(monkeypatch):
    monkeypatch.setenv(fault_injection.ENV_VAR,
                       '{"corrupt_chunk": {"every": 2}, '
                       '"truncate_spill": {"every": 1, "keep": 0.25}, '
                       '"drop_fetch_reply": 3}')
    spec = fault_injection.FaultSpec.from_env()
    assert spec.corrupt_chunk == {"every": 2}
    assert spec.truncate_spill == {"every": 1, "keep": 0.25}
    assert spec.drop_fetch_reply == 3


def test_corrupt_chunk_every_nth_deterministic():
    fault_injection.set_spec(corrupt_chunk={"every": 2})
    try:
        served = [fault_injection.corrupt_chunk(b"\x00zz") for _ in range(4)]
        assert [d[0] for d in served] == [0, 1, 0, 1]
        assert all(d[1:] == b"zz" for d in served)
    finally:
        fault_injection.clear_spec()
    # Inactive spec: bytes pass through untouched.
    assert fault_injection.corrupt_chunk(b"\x00zz") == b"\x00zz"


def test_drop_fetch_reply_cadence():
    fault_injection.set_spec(drop_fetch_reply={"every": 3})
    try:
        assert [fault_injection.drop_fetch_reply() for _ in range(6)] == \
            [False, False, True, False, False, True]
    finally:
        fault_injection.clear_spec()


def test_truncate_spill_fault(tmp_path):
    p = str(tmp_path / "o.bin")
    ot.write_spill_file(p, b"z" * 1000)
    size = os.path.getsize(p)
    fault_injection.set_spec(truncate_spill={"every": 1, "keep": 0.5})
    try:
        assert fault_injection.truncate_spill(p)
    finally:
        fault_injection.clear_spec()
    assert os.path.getsize(p) == size // 2
    with pytest.raises(ot.ChecksumError):
        ot.read_spill_file(p)


# ------------------------------------------------------------ GCS directory


class _FakeConn:
    closed = False

    async def request(self, msg, timeout=None):
        return {"ok": True}

    async def notify(self, msg):
        return None


def test_gcs_checksum_stamp_and_invalidate():
    async def run():
        gcs = GcsServer()
        add = gcs._h_object_location_add
        await add(None, {"object_id": "obj1", "node_id": "nodeA",
                         "owner": "w", "size": 8, "checksum": 1234})
        # A puller's add (no checksum) must not clear the creator's stamp.
        await add(None, {"object_id": "obj1", "node_id": "nodeB"})
        loc = await gcs._h_object_locations_get(None, {"object_id": "obj1"})
        assert loc["checksum"] == 1234
        assert set(loc["nodes"]) == {"nodeA", "nodeB"}
        # Reconstruction re-stamps through the same path (non-deterministic
        # producers yield different bytes; the new stamp wins).
        await add(None, {"object_id": "obj1", "node_id": "nodeA",
                         "checksum": 5678})
        loc = await gcs._h_object_locations_get(None, {"object_id": "obj1"})
        assert loc["checksum"] == 5678
        many = await gcs._h_object_locations_get_many(
            None, {"object_ids": ["obj1"]})
        assert many["obj1"]["checksum"] == 5678

        inv = gcs._h_object_location_invalidate
        r = await inv(None, {"object_id": "obj1", "node_id": "nodeA"})
        assert r["removed"]
        loc = await gcs._h_object_locations_get(None, {"object_id": "obj1"})
        assert loc["nodes"] == ["nodeB"]
        assert gcs.object_invalidations == {"nodeA": 1}
        # Last copy invalidated -> the entry itself goes (consumers fall to
        # lineage, not to a directory entry with zero locations).
        await inv(None, {"object_id": "obj1", "node_id": "nodeB"})
        assert await gcs._h_object_locations_get(
            None, {"object_id": "obj1"}) is None
        # Unknown object: strike still recorded, nothing removed.
        r = await inv(None, {"object_id": "ghost", "node_id": "nodeA"})
        assert not r["removed"]
        assert gcs.object_invalidations == {"nodeA": 2, "nodeB": 1}
        stats = await gcs._h_get_node_stats(None, {})
        assert stats["invalidations"] == {"nodeA": 2, "nodeB": 1}

    asyncio.run(run())


def test_gcs_folds_data_plane_counters_on_node_death():
    async def run():
        gcs = GcsServer()
        nid = NodeID.from_random()
        gcs.nodes[nid] = NodeInfo(
            node_id=nid, address="a", store_name="x",
            resources_total={"CPU": 1.0}, resources_available={"CPU": 1.0},
            conn=_FakeConn())
        gcs.node_stats[nid.hex()] = {
            "spilled_objects": 3, "restored_objects": 2,
            "objects_corrupted": 5, "pull_retries": 7,
            "spill_fsync_ms": 11.5}
        await gcs._mark_node_dead(gcs.nodes[nid])
        dead = gcs.dead_spill_totals()
        assert dead["objects_corrupted"] == 5
        assert dead["pull_retries"] == 7
        assert dead["spill_fsync_ms"] == 11.5

    asyncio.run(run())


# ------------------------------------------- in-process raylet pull harness


class _GcsConn:
    """Raylet 'gcs_conn' that dispatches straight into a GcsServer, with
    optional scripted per-message-type failures."""

    closed = False

    def __init__(self, gcs):
        self.gcs = gcs
        self.fail_counts = {}   # msg type -> remaining failures

    async def request(self, msg, timeout=None):
        left = self.fail_counts.get(msg["type"], 0)
        if left > 0:
            self.fail_counts[msg["type"]] = left - 1
            raise ConnectionError(f"injected {msg['type']} failure")
        return await getattr(self.gcs, f"_h_{msg['type']}")(None, msg)

    async def notify(self, msg):
        await self.request(msg)


class _DirectPeer:
    """Peer RpcConnection shim dispatching into another raylet's handlers.
    ``hook(peer, msg)`` runs before each request — the corruption/race
    injection point."""

    closed = False

    def __init__(self, raylet, hook=None):
        self.raylet = raylet
        self.hook = hook
        self.requests = 0

    async def request(self, msg, timeout=None):
        self.requests += 1
        if self.hook is not None:
            r = self.hook(self, msg)
            if asyncio.iscoroutine(r):
                await r
        reply = await getattr(self.raylet,
                              f"_h_{msg['type']}")(None, msg)
        return reply


@contextlib.contextmanager
def _no_forkserver():
    """In-process raylets start no forkserver template.  The raylet reads
    the switch when it is built, so it is set only around that and put
    back after: later tests in this process start clusters that fork."""
    old = os.environ.get("RT_DISABLE_FORKSERVER")
    os.environ["RT_DISABLE_FORKSERVER"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RT_DISABLE_FORKSERVER", None)
        else:
            os.environ["RT_DISABLE_FORKSERVER"] = old


class _Harness:
    """A GcsServer plus N real Raylets wired together in-process."""

    def __init__(self, n, store_capacity=8 * 1024 * 1024):
        from ray_tpu_torch._private.raylet import Raylet
        self.gcs = GcsServer()
        self.raylets = []
        for i in range(n):
            nid = NodeID.from_random()
            with _no_forkserver():
                r = Raylet(node_id=nid, gcs_address="",
                           resources={"CPU": 1.0},
                           store_capacity=store_capacity)
            r.gcs_conn = _GcsConn(self.gcs)
            self.gcs.nodes[nid] = NodeInfo(
                node_id=nid, address=f"node-{i}", store_name=r.store_name,
                resources_total={"CPU": 1.0},
                resources_available={"CPU": 1.0}, conn=_FakeConn())
            self.raylets.append(r)
        # Full peer mesh: every raylet can "connect" to every other.
        for a in self.raylets:
            for j, b in enumerate(self.raylets):
                if a is not b:
                    a._peer_conns[f"node-{j}"] = _DirectPeer(b)

    def peer(self, from_idx, to_idx):
        return self.raylets[from_idx]._peer_conns[f"node-{to_idx}"]

    async def seal(self, idx, oid, data, register=True):
        r = self.raylets[idx]
        buf = r.plasma.create(oid, len(data))
        buf[:len(data)] = data
        r.plasma.seal(oid)
        r.plasma.release(oid)
        if register:
            await self.gcs._h_object_location_add(None, {
                "object_id": oid.hex(), "node_id": r.node_id.hex(),
                "owner": "t", "size": len(data),
                "checksum": ot.crc32_bytes(data)})

    async def spill(self, idx, oid, data, register=True, checksum=None):
        """Place a spilled-only copy of ``data`` on raylet ``idx``."""
        r = self.raylets[idx]
        path = r._spill_path(oid.hex())
        ot.write_spill_file(path, data, do_fsync=False)
        if register:
            await self.gcs._h_object_location_add(None, {
                "object_id": oid.hex(), "node_id": r.node_id.hex(),
                "owner": "t", "size": len(data),
                "checksum": checksum if checksum is not None
                else ot.crc32_bytes(data)})
            await self.gcs._h_object_spilled(None, {
                "object_id": oid.hex(), "node_id": r.node_id.hex(),
                "path": path})
        return path

    def read(self, idx, oid):
        r = self.raylets[idx]
        view = r.plasma.get(oid)
        assert view is not None
        try:
            return bytes(view)
        finally:
            view.release()
            r.plasma.release(oid)

    def close(self):
        for r in self.raylets:
            try:
                r.plasma.close()
            except Exception:
                pass
            try:
                os.unlink(os.path.join("/dev/shm",
                                       r.store_name.lstrip("/")))
            except OSError:
                pass
            shutil.rmtree(r.spill_dir, ignore_errors=True)


@pytest.fixture()
def fast_retry():
    """Shrink pull backoff so exhausted-retry tests stay sub-second."""
    cfg = config()
    saved = (cfg.pull_retry_attempts, cfg.pull_retry_backoff_base_s,
             cfg.pull_retry_backoff_max_s, cfg.transfer_chunk_bytes)
    cfg.pull_retry_backoff_base_s = 0.01
    cfg.pull_retry_backoff_max_s = 0.02
    yield cfg
    (cfg.pull_retry_attempts, cfg.pull_retry_backoff_base_s,
     cfg.pull_retry_backoff_max_s, cfg.transfer_chunk_bytes) = saved


def test_pull_quarantines_corrupt_copy_and_falls_through(fast_retry):
    """A holder serving bit-flipped bytes is invalidated in the directory
    and the puller seals the healthy copy from the next holder — the
    corrupt bytes are never sealed."""
    async def run():
        h = _Harness(3)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(100_000)
            await h.seal(0, oid, data)          # corrupt-serving holder
            await h.seal(1, oid, data)          # healthy holder
            # Corrupt node-0's *served* frames (transit corruption).
            orig = h.peer(2, 0).raylet._h_fetch_object

            async def corrupt_fetch(conn, msg):
                reply = await orig(conn, msg)
                if reply.get("found") and reply.get("data"):
                    d = bytearray(reply["data"])
                    d[0] ^= 0x01
                    reply["data"] = bytes(d)
                return reply

            h.raylets[0]._h_fetch_object = corrupt_fetch
            # Deterministic candidate order: nodes is a set, so pin the
            # corrupt holder first by rebuilding the entry.
            entry = h.gcs.object_dir[oid.hex()]
            ordered = ObjectDirEntry(
                entry.owner, size=entry.size, checksum=entry.checksum)
            ordered.nodes = _OrderedSet(
                [h.raylets[0].node_id.hex(), h.raylets[1].node_id.hex()])
            h.gcs.object_dir[oid.hex()] = ordered

            puller = h.raylets[2]
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert reply["ok"], reply
            assert h.read(2, oid) == data
            assert puller._objects_corrupted == 1
            # The corrupt holder is gone from the directory; the puller
            # advertised its verified copy.
            loc = await h.gcs._h_object_locations_get(
                None, {"object_id": oid.hex()})
            assert h.raylets[0].node_id.hex() not in loc["nodes"]
            assert puller.node_id.hex() in loc["nodes"]
            assert h.gcs.object_invalidations == {
                h.raylets[0].node_id.hex(): 1}
        finally:
            h.close()

    asyncio.run(run())


class _OrderedSet(list):
    """Set-shaped list: deterministic iteration order for candidate-order
    tests (entry.nodes is a set in production)."""

    def add(self, x):
        if x not in self:
            self.append(x)

    def discard(self, x):
        if x in self:
            self.remove(x)


def test_restore_spilled_quarantines_torn_file(fast_retry):
    async def run():
        h = _Harness(1)
        try:
            oid = ObjectID.from_random()
            path = await h.spill(0, oid, b"q" * 50_000)
            os.truncate(path, os.path.getsize(path) // 2)
            r = h.raylets[0]
            assert not await r._restore_spilled(oid)
            assert not os.path.exists(path)          # quarantined
            assert r._objects_corrupted == 1
            assert not r.plasma.contains(oid)        # garbage never sealed
            # The spill location is gone from the directory (last copy ->
            # whole entry), and the strike is counted against this node.
            assert oid.hex() not in h.gcs.object_dir
            assert h.gcs.object_invalidations == {r.node_id.hex(): 1}
            # Pulling it now reports failure to the owner (lineage's cue).
            reply = await r._h_pull_object(None, {"object_id": oid.hex()})
            assert not reply["ok"]
        finally:
            h.close()

    asyncio.run(run())


def test_fetch_during_spill_delete_race(fast_retry):
    """S3 race: a holder's spill file disappears mid-chunked-fetch (spill
    delete / object freed).  The puller must abort that candidate cleanly,
    free its half-written plasma allocation, and fall through to the next
    holder."""
    fast_retry.transfer_chunk_bytes = 8192   # multi-chunk transfers

    async def run():
        h = _Harness(3)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(50_000)         # 7 chunks
            path0 = await h.spill(0, oid, data)

            def delete_after_first(peer, msg):
                if peer.requests > 1 and os.path.exists(path0):
                    os.unlink(path0)

            h.peer(2, 0).hook = delete_after_first
            puller = h.raylets[2]
            # Only holder races away -> the pull fails, but CLEANLY: reply
            # not exception, and no half-written allocation left behind.
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert not reply["ok"]
            assert not puller.plasma.contains(oid)

            # Same race with a second healthy (spilled) holder: candidate
            # fall-through serves the object in the same round.
            path0 = await h.spill(0, oid, data)
            await h.spill(1, oid, data)
            h.peer(2, 0).requests = 0
            retries_before = puller._pull_retries
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert reply["ok"], reply
            assert h.read(2, oid) == data
            assert puller._pull_retries == retries_before  # same-round
        finally:
            h.close()

    asyncio.run(run())


def test_pull_retry_absorbs_flaky_holder(fast_retry):
    """A holder erroring on its first fetch (dropped reply / transient
    disconnect) costs a backoff round, not an ObjectLostError."""
    async def run():
        h = _Harness(2)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(10_000)
            await h.seal(0, oid, data)
            fails = {"left": 1}

            def flaky(peer, msg):
                if fails["left"] > 0:
                    fails["left"] -= 1
                    raise RuntimeError("injected fetch failure")

            h.peer(1, 0).hook = flaky
            puller = h.raylets[1]
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert reply["ok"], reply
            assert h.read(1, oid) == data
            assert puller._pull_retries == 1
            assert puller._objects_corrupted == 0
        finally:
            h.close()

    asyncio.run(run())


def test_pull_exhausts_retries_then_fails(fast_retry):
    async def run():
        h = _Harness(2)
        try:
            oid = ObjectID.from_random()
            await h.seal(0, oid, b"g" * 1000)

            def always_down(peer, msg):
                raise RuntimeError("holder unreachable")

            h.peer(1, 0).hook = always_down
            puller = h.raylets[1]
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert not reply["ok"]
            assert "failed" in reply["error"]
            assert puller._pull_retries == \
                config().pull_retry_attempts - 1
        finally:
            h.close()

    asyncio.run(run())


def test_pull_object_store_full_is_a_reply_not_a_crash(fast_retry):
    """S2: an ObjectStoreFullError mid-pull surfaces as {"ok": False} so
    the owner can react, instead of an unhandled handler exception."""
    async def run():
        h = _Harness(2, store_capacity=1024 * 1024)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(900_000)
            await h.seal(0, oid, data)
            # Fill the puller's store with pinned garbage so the pull's
            # allocation cannot fit (unsealed objects can't be evicted).
            blocker = ObjectID.from_random()
            h.raylets[1].plasma.create(blocker, 700_000)
            reply = await h.raylets[1]._h_pull_object(
                None, {"object_id": oid.hex()})
            assert not reply["ok"]
            assert "full" in reply["error"]
        finally:
            h.close()

    asyncio.run(run())


def test_register_pulled_retries_location_add_once(fast_retry):
    async def run():
        h = _Harness(2)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(5_000)
            await h.seal(0, oid, data)
            puller = h.raylets[1]
            # First add attempt fails; the retry must land the location.
            puller.gcs_conn.fail_counts["object_location_add"] = 1
            reply = await puller._h_pull_object(
                None, {"object_id": oid.hex()})
            assert reply["ok"], reply
            loc = await h.gcs._h_object_locations_get(
                None, {"object_id": oid.hex()})
            assert puller.node_id.hex() in loc["nodes"]
        finally:
            h.close()

    asyncio.run(run())


def test_push_receiver_rejects_corrupt_assembly(fast_retry):
    """Push side of the same contract: a receiver never seals an assembly
    that fails the directory checksum, and quarantines the pusher."""
    fast_retry.transfer_chunk_bytes = 4096

    async def run():
        h = _Harness(2)
        try:
            oid = ObjectID.from_random()
            data = os.urandom(20_000)
            await h.seal(0, oid, data)
            src = h.raylets[0]
            dst = h.raylets[1]
            view = src.plasma.get(oid)
            try:
                tampered = bytearray(bytes(view))
            finally:
                view.release()
                src.plasma.release(oid)
            tampered[0] ^= 0x01
            ok = await ot.push_object_chunks(
                h.peer(0, 1), oid.hex(), memoryview(tampered),
                len(tampered), 4096, inflight=2,
                checksum=ot.crc32_bytes(data),
                src_node=src.node_id.hex())
            assert not ok
            assert not dst.plasma.contains(oid)
            assert dst._objects_corrupted == 1
            assert h.gcs.object_invalidations == {src.node_id.hex(): 1}
            # An honest push of the same object then succeeds.
            view = src.plasma.get(oid)
            try:
                ok = await ot.push_object_chunks(
                    h.peer(0, 1), oid.hex(), view, len(view), 4096,
                    inflight=2, checksum=ot.crc32_bytes(data),
                    src_node=src.node_id.hex())
            finally:
                view.release()
                src.plasma.release(oid)
            assert ok
            assert h.read(1, oid) == data
        finally:
            h.close()

    asyncio.run(run())


def test_raylet_sweeps_orphan_tmp_files_at_start():
    from ray_tpu_torch._private.raylet import Raylet
    import tempfile
    nid = NodeID.from_random()
    spill_dir = os.path.join(
        tempfile.gettempdir(), f"rtt_spill_{os.getpid()}_{nid.hex()[:12]}")
    os.makedirs(spill_dir, exist_ok=True)
    orphan = os.path.join(spill_dir, "deadbeef.bin.tmp")
    keeper = os.path.join(spill_dir, "cafebabe.bin")
    open(orphan, "wb").write(b"torn tmp write")
    ot.write_spill_file(keeper, b"complete spill", do_fsync=False)
    with _no_forkserver():
        r = Raylet(node_id=nid, gcs_address="", resources={"CPU": 1.0},
                   store_capacity=1024 * 1024)
    try:
        assert not os.path.exists(orphan)
        assert os.path.exists(keeper)   # complete spills survive the sweep
    finally:
        r.plasma.close()
        try:
            os.unlink(os.path.join("/dev/shm", r.store_name.lstrip("/")))
        except OSError:
            pass
        shutil.rmtree(spill_dir, ignore_errors=True)


def test_node_stats_carry_data_plane_counters():
    from ray_tpu_torch._private.raylet import Raylet
    nid = NodeID.from_random()
    with _no_forkserver():
        r = Raylet(node_id=nid, gcs_address="", resources={"CPU": 1.0},
                   store_capacity=1024 * 1024)
    try:
        r._objects_corrupted = 2
        r._pull_retries = 9
        r._spill_fsync_ms = 3.14159
        st = r._collect_node_stats({})
        assert st["objects_corrupted"] == 2
        assert st["pull_retries"] == 9
        assert st["spill_fsync_ms"] == 3.142
    finally:
        r.plasma.close()
        try:
            os.unlink(os.path.join("/dev/shm", r.store_name.lstrip("/")))
        except OSError:
            pass
        shutil.rmtree(r.spill_dir, ignore_errors=True)
