"""Wire-format v2 codec and RPC transport of the port's runtime, case for
case those of ``test_wire.py`` and then of ``test_protocol.py``.

Covers the binary hot-path framing (ray_tpu_torch/_private/wire.py):
round trips over the fast-lane type set, zero-copy big buffers, the
pickle fallback and its counters, malformed frames raising
WireDecodeError, handshake version negotiation, the zero-pickle
acceptance check and frame-drop chaos (marker: wire_chaos); then the
RpcConnection transport: outbox coalescing, backpressure bounds, and
prompt failure of in-flight requests on a broken peer.  That the framing
is byte-identical to ``ray_tpu``'s is held in
``test_torch_runtime_parity.py``.
"""

import asyncio
import pickle
import random

import pytest

from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private.protocol import (ConnectionLost,
                                             ReconnectingConnection,
                                             RpcConnection, RpcServer,
                                             connect)
from ray_tpu_torch._private.wire import (BATCH, BODY_MARSHAL, BODY_PICKLE,
                                   BODY_TAGGED, NOTIFY, OOB_THRESHOLD,
                                   REPLY, REQUEST, PreEncoded,
                                   WireDecodeError, decode_frame,
                                   decode_value, encode_batch_frame,
                                   encode_batch_frame_fast,
                                   encode_batch_item, encode_frame,
                                   encode_value)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _stats_delta(before: dict) -> dict:
    return {k: wire.stats[k] - before.get(k, 0) for k in wire.stats}


# ------------------------------------------------------------ value codec

FAST_LANE_VALUES = [
    None, True, False,
    0, 1, -1, 2**63 - 1, -2**63,            # int64 edge
    2**63, -2**63 - 1, 2**200, -2**200,     # bigint lane
    0.0, -1.5, 3.141592653589793, float("inf"), float("-inf"),
    "", "hello", "unicode: é漢\U0001f600",
    b"", b"bytes", b"\x00\x80\xff" * 11,
    [], [1, 2, 3], (4, 5), {}, {"k": "v", "n": 1},
    {"nested": [{"a": (1, 2, [3, {"deep": None}])}, b"x"]},
]


@pytest.mark.parametrize("value", FAST_LANE_VALUES,
                         ids=[repr(v)[:40] for v in FAST_LANE_VALUES])
def test_tagged_value_roundtrip(value):
    assert decode_value(encode_value(value)) == value


def test_tagged_nan_roundtrip():
    v = decode_value(encode_value(float("nan")))
    assert v != v                             # NaN, preserved as a float


def test_tagged_bytearray_and_memoryview_become_bytes():
    assert decode_value(encode_value(bytearray(b"abc"))) == b"abc"
    assert decode_value(encode_value(memoryview(b"abcd"))) == b"abcd"


def test_tagged_roundtrip_property_sweep():
    """Seeded random nested structures from the fast-lane type set."""
    rng = random.Random(0xB7)

    def gen(depth):
        kind = rng.randrange(9 if depth < 4 else 6)
        if kind == 0:
            return rng.choice([None, True, False])
        if kind == 1:
            return rng.randrange(-2**70, 2**70)
        if kind == 2:
            return rng.random() * 10**rng.randrange(-5, 6)
        if kind == 3:
            return "".join(chr(rng.randrange(32, 0x2FF))
                           for _ in range(rng.randrange(8)))
        if kind == 4:
            return bytes(rng.randrange(256)
                         for _ in range(rng.randrange(12)))
        if kind == 5:
            return rng.randrange(-2**31, 2**31)
        n = rng.randrange(4)
        if kind == 6:
            return [gen(depth + 1) for _ in range(n)]
        if kind == 7:
            return tuple(gen(depth + 1) for _ in range(n))
        return {f"k{i}": gen(depth + 1) for i in range(n)}

    for _ in range(300):
        v = gen(0)
        assert decode_value(encode_value(v)) == v


def test_big_buffer_zero_copy_memoryview():
    """bytes >= OOB_THRESHOLD decode as a memoryview OVER the frame
    buffer — no copy on the receive path."""
    payload = b"\xab" * (OOB_THRESHOLD + 17)
    buf = encode_value({"data": payload, "meta": 1})
    out = decode_value(buf)
    assert isinstance(out["data"], memoryview)
    assert out["data"].obj is buf             # zero copy: view of the frame
    assert bytes(out["data"]) == payload
    assert out["meta"] == 1


def test_small_bytes_copied_not_viewed():
    out = decode_value(encode_value(b"small"))
    assert type(out) is bytes


class Custom:
    """Module-level so the pickle fallback can serialize it."""

    def __init__(self, x):
        self.x = x

    def __eq__(self, other):
        return type(other) is Custom and other.x == self.x


def test_pickle_fallback_objects_roundtrip_and_count():
    before = dict(wire.stats)
    for v in [{1, 2, 3}, Custom(7), {"obj": Custom(1), "ok": True}]:
        assert decode_value(encode_value(v)) == v
    d = _stats_delta(before)
    assert d["encode_pickle_fallback"] == 3
    assert d["decode_pickle_fallback"] == 3


def test_fast_lane_values_never_touch_pickle():
    before = dict(wire.stats)
    for v in FAST_LANE_VALUES:
        decode_value(encode_value(v))
        kind, rid, msg = decode_frame(encode_frame(REQUEST, 1, {"v": v},
                                                   fast=True))
        assert msg == {"v": v}
    d = _stats_delta(before)
    assert d["encode_pickle_fallback"] == 0
    assert d["decode_pickle_fallback"] == 0


# ------------------------------------------------------------ frame codec

def test_frame_roundtrip_marshal_lane():
    msg = {"type": "actor_call", "method": "ping", "args": [1, 2.5, "s"],
           "kwargs": {}, "seq": 3}
    buf = encode_frame(REQUEST, 42, msg, fast=True)
    assert buf[0] == wire.MAGIC
    assert buf[2] & 0x03 == BODY_MARSHAL
    assert decode_frame(buf) == (REQUEST, 42, msg)


def test_frame_roundtrip_pickle_lane():
    msg = {"err": ValueError("boom")}
    buf = encode_frame(REPLY, 7, msg, fast=False)
    assert buf[2] & 0x03 == BODY_PICKLE
    kind, rid, out = decode_frame(buf)
    assert (kind, rid) == (REPLY, 7)
    assert type(out["err"]) is ValueError


def test_frame_roundtrip_tagged_big_buffer():
    msg = {"data": b"z" * OOB_THRESHOLD, "chunk": 4}
    buf = encode_frame(NOTIFY, 0, msg, fast=True)
    assert buf[2] & 0x03 == BODY_TAGGED       # big buffer routes off marshal
    kind, rid, out = decode_frame(buf)
    assert isinstance(out["data"], memoryview) and out["data"].nbytes == \
        OOB_THRESHOLD


def test_frame_rid_boundaries():
    for rid in (0, 1, 2**64 - 1):
        assert decode_frame(encode_frame(REPLY, rid, None))[1] == rid


def test_batch_whole_marshal_roundtrip():
    items = [(REQUEST, i, {"x": i}) for i in range(30)]
    buf = encode_batch_frame_fast(items)
    assert buf is not None and buf[2] & 0x03 == BODY_MARSHAL
    kind, rid, out = decode_frame(buf)
    assert kind == BATCH and [tuple(i) for i in out] == items


def test_batch_mixed_items_roundtrip():
    pre = PreEncoded({"spliced": True, "n": 9})
    parts = [encode_batch_item(REQUEST, 1, {"a": 1}, fast=True),
             encode_batch_item(REPLY, 2, Custom(5), fast=True),  # pickle item
             encode_batch_item(NOTIFY, 3, pre, fast=True),
             encode_batch_item(REQUEST, 4,
                               {"data": b"B" * OOB_THRESHOLD}, fast=True)]
    kind, rid, out = decode_frame(bytes(encode_batch_frame(parts)))
    assert kind == BATCH and len(out) == 4
    assert out[0] == (REQUEST, 1, {"a": 1})
    assert out[1][:2] == (REPLY, 2) and out[1][2] == Custom(5)
    assert out[2] == (NOTIFY, 3, {"spliced": True, "n": 9})
    assert out[3][2]["data"].nbytes == OOB_THRESHOLD


def test_preencoded_encodes_once_and_pickles_plain():
    msg = {"type": "push_task", "spec": {"f": "g"}}
    pre = PreEncoded(msg)
    a = pre.encoded(True)
    assert pre.encoded(True) is a             # cached, not re-encoded
    assert pickle.loads(pickle.dumps(pre)) == msg


# ------------------------------------------------- malformed / truncated

def test_decode_frame_rejects_short_and_bad_magic():
    with pytest.raises(WireDecodeError):
        decode_frame(b"")
    with pytest.raises(WireDecodeError):
        decode_frame(b"\xb7\x00")             # truncated header
    with pytest.raises(WireDecodeError):
        decode_frame(b"\x99" + b"\x00" * 10)  # wrong magic


def test_decode_frame_rejects_truncated_bodies():
    whole = encode_frame(REQUEST, 5, {"k": "v", "n": 12345}, fast=True)
    for cut in (wire.HEADER_SIZE + 1, len(whole) - 1):
        with pytest.raises(WireDecodeError):
            decode_frame(whole[:cut])
    tagged = encode_frame(REQUEST, 5, {"data": b"x" * OOB_THRESHOLD})
    with pytest.raises(WireDecodeError):
        decode_frame(tagged[:len(tagged) - 7])


def test_decode_frame_rejects_unknown_codec_and_bad_batch():
    hdr = bytearray(encode_frame(REQUEST, 1, {"a": 1}))
    hdr[2] = 0x03                             # reserved codec bits
    with pytest.raises(WireDecodeError):
        decode_frame(bytes(hdr))
    # batch item whose declared length overruns the frame
    item = bytearray(encode_batch_item(REQUEST, 1, {"a": 1}))
    item[0] = 0xFF
    with pytest.raises(WireDecodeError):
        decode_frame(bytes(encode_batch_frame([bytes(item)])))


def test_decode_value_rejects_malformed():
    for bad in (b"", b"\xff", b"\x05\xff\xff\xff\x7f",  # huge str length
                b"\x03\x01",                            # short int64
                encode_value("ok") + b"\x00"):          # trailing garbage
        with pytest.raises(WireDecodeError):
            decode_value(bad)


def test_decode_value_rejects_corrupt_pickle_tag():
    buf = bytearray(encode_value({1, 2}))     # set -> T_PICKLE
    buf[-1] ^= 0xFF
    with pytest.raises(WireDecodeError):
        decode_value(bytes(buf))


# ------------------------------------------------------------ negotiation

async def _echo(msg):
    return msg.get("x")


def test_handshake_v2_both_sides():
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="neg")
        assert await c.request({"x": 1}) == 1      # hello precedes request
        assert c.peer_wire_version == 2 and c._peer_fast
        sconn = server.connections[0]
        assert sconn.peer_wire_version == 2 and sconn._peer_fast
        await c.close()
        await server.close()

    _run(main())


def test_handshake_legacy_pin_keeps_link_on_pickle(monkeypatch):
    """RT_WIRE_V2=0 pins this process's send side to legacy pickle
    framing; the un-pinned peer sees no hello and answers in legacy
    framing too — a mixed-version link heals to the old format."""
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        monkeypatch.setenv("RT_WIRE_V2", "0")
        try:
            c = await connect(server.address, _echo, name="pinned")
            assert not c._wire_v2
            assert await c.request({"x": 2}) == 2
            assert await asyncio.gather(
                *c.request_batch([{"x": i} for i in range(10)])) == \
                list(range(10))
            sconn = server.connections[0]
            assert sconn.peer_wire_version == 1    # no hello arrived
            assert not sconn._peer_fast
        finally:
            monkeypatch.delenv("RT_WIRE_V2")
        await c.close()
        await server.close()

    _run(main())


def test_hello_v1_downgrades_send_side():
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="v1")
        c._apply_hello({"type": wire.HELLO_TYPE, "v": 1})
        assert c.peer_wire_version == 1
        assert await c.request({"x": 3}) == 3      # legacy-framed send
        await c.close()
        await server.close()

    _run(main())


def test_reconnect_renegotiates_wire_version():
    """A redialed ReconnectingConnection starts from the legacy default
    and re-upgrades via a fresh hello exchange."""
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        addr = server.address
        r = ReconnectingConnection(addr, _echo, name="heal",
                                   backoff_base_s=0.05)
        await r.dial()
        assert await r.request({"x": 1}) == 1
        assert r.peer_wire_version == 2
        # Drop the link server-side; the client redials the same port.
        await server.close()
        server2 = RpcServer(lambda conn: _echo)
        await server2.start(int(addr.rsplit(":", 1)[1]))
        for _ in range(100):
            try:
                assert await r.request({"x": 9}, timeout=2) == 9
                break
            except Exception:
                await asyncio.sleep(0.1)
        else:
            raise AssertionError("never reconnected")
        assert r.peer_wire_version == 2            # renegotiated, not stale
        assert r.reconnects >= 1
        await r.close()
        await server2.close()

    _run(main())


# ----------------------------------------------- end-to-end zero pickle

def test_rpc_fast_lane_workload_is_pickle_free():
    """Requests and replies built from fast-lane values cross a live
    RpcConnection without a single frame-codec pickle on either side
    (the acceptance instrumentation for the zero-pickle lane)."""
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="zp")
        await c.request({"x": 0})                  # handshake settles
        before = dict(wire.stats)
        for i in range(25):
            assert await c.request({"x": i, "pad": "v" * 32}) == i
        futs = c.request_batch([{"x": i, "blob": b"b" * 64}
                                for i in range(40)])
        assert await asyncio.gather(*futs) == list(range(40))
        d = _stats_delta(before)
        assert d["encode_pickle_fallback"] == 0
        assert d["decode_pickle_fallback"] == 0
        assert d["body_pickle"] == 0
        assert d["body_marshal"] > 0
        await c.close()
        await server.close()

    _run(main())


# ------------------------------------------------------------ wire chaos

@pytest.mark.chaos
@pytest.mark.wire_chaos
def test_request_batch_survives_dropped_v2_frames():
    """The existing RPC frame-drop fault, applied to the new framing:
    periodically dropping outgoing v2 frames must surface as request
    timeouts/connection errors the caller can retry — never as a codec
    error, a misrouted reply, or a wrong value."""
    from ray_tpu_torch.util import fault_injection

    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="lossy-wire")
        await c.request({"x": 0})
        protocol.set_frame_fault(
            fault_injection.make_drop_filter("lossy-wire", every=7))
        try:
            got, errors = 0, 0
            for i in range(60):
                try:
                    v = await c.request({"x": i}, timeout=0.3)
                    assert v == i              # never a misrouted reply
                    got += 1
                except (asyncio.TimeoutError, protocol.ConnectionLost):
                    errors += 1
            assert got > 0 and errors > 0      # fault really fired
        finally:
            protocol.set_frame_fault(None)
        # the link still works once the fault clears
        assert await c.request({"x": 123}, timeout=5) == 123
        await c.close()
        await server.close()

    _run(main())


# ------------------------------------------------- transport (test_protocol)

def test_request_reply_roundtrip_and_batch():
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="t")
        assert await c.request({"x": 1}) == 1
        futs = c.request_batch([{"x": i} for i in range(50)])
        assert await asyncio.gather(*futs) == list(range(50))
        await c.close()
        await server.close()

    _run(main())


def test_writer_buffer_stays_bounded_under_stalled_peer():
    """With the peer's reads paused, a bulk sender must suspend on drain
    once ~1MB is outstanding — frames must not accumulate without bound
    in this process's transport buffer."""
    async def main():
        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        c = await connect(server.address, _echo, name="stall")
        await asyncio.sleep(0.1)           # let the server register it
        assert server.connections
        for conn in server.connections:    # peer stops reading
            conn.writer.transport.pause_reading()

        sent = 0

        async def sender():
            nonlocal sent
            payload = b"x" * (256 * 1024)
            for _ in range(400):           # 100MB if nothing pushed back
                await c._send_frame(payload)
                sent += 1

        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sender(), timeout=2)
        buffered = c.writer.transport.get_write_buffer_size()
        # Kernel socket buffers absorb a few MB; the python-side transport
        # buffer must stay near the 1MB drain threshold, nowhere near the
        # 100MB the sender would have queued without backpressure.
        assert buffered < 8 * (1 << 20), f"transport buffered {buffered}"
        assert sent < 400, "sender was never suspended by drain"
        await c.close()
        await server.close()

    _run(main())


def test_broken_connection_fails_inflight_request_promptly():
    async def main():
        async def slow_handler(msg):
            await asyncio.sleep(3600)

        server = RpcServer(lambda conn: slow_handler)
        await server.start(0)
        c = await connect(server.address, slow_handler, name="break")
        t = asyncio.ensure_future(c.request({"x": 1}))
        await asyncio.sleep(0.2)           # request in flight, unanswered
        for conn in list(server.connections):
            conn.writer.transport.abort()  # peer dies mid-request
        with pytest.raises(ConnectionLost):
            await asyncio.wait_for(t, timeout=5)
        await c.close()
        await server.close()

    _run(main())


def test_outbox_coalesces_within_tick():
    """Many requests issued in one loop tick leave as ONE _BATCH frame."""
    async def main():
        frames = []

        class CountingConn(RpcConnection):
            def _write_frame_nowait(self, payload):
                frames.append(len(payload))
                super()._write_frame_nowait(payload)

        server = RpcServer(lambda conn: _echo)
        await server.start(0)
        host, port = server.address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        c = CountingConn(reader, writer, _echo, name="count")
        c.start()
        futs = c.request_batch([{"x": i} for i in range(40)])
        assert await asyncio.gather(*futs) == list(range(40))
        assert len(frames) == 1, f"expected one coalesced frame: {frames}"
        await c.close()
        await server.close()

    _run(main())
