"""Streaming inference: generator streaming protocol, paged KV decode,
continuous batching, SSE ingress.

Reference analogs: python/ray/tests/test_streaming_generator.py (per-yield
object refs consumable mid-task), vLLM's paged-attention equivalence tests,
python/ray/serve/tests/test_proxy + streaming response tests.

The port's runtime under ``test_serve_streaming.py``'s cases.  The engine
and allocator cases and the LLaMA paged-decode case have their mirrors in
``test_torch_serve_engine.py`` and ``test_torch_llama.py`` (held to the
JAX package there); this file holds the rest, and imports no JAX: the
cluster's workers import it.
"""

import asyncio
import json
import socket
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=16)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _tiny_gpt():
    from ray_tpu_torch.models.gpt import GPTConfig
    # f32 end to end: the paged-vs-dense equivalence below is exact in
    # f32; bf16 would add rounding nondeterminism to the argmax.
    return GPTConfig(vocab_size=97, max_seq_len=96, num_layers=2,
                     num_heads=4, embed_dim=32, dtype=torch.float32,
                     attention="dense", remat=False)


# ------------------------------------------------------ core streaming


def test_streaming_task_refs_and_completion(serve_cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    g = gen.remote(5)
    assert isinstance(g, ray_tpu_torch.StreamingObjectRefGenerator)
    # Hold the yielded refs: dropping them frees the per-yield objects
    # (each yield is an owned, refcounted object like any task return).
    yielded = list(g)
    vals = [ray_tpu_torch.get(r, timeout=30) for r in yielded]
    assert vals == [0, 10, 20, 30, 40]
    # The ref0 terminal holds an ObjectRefGenerator over every yield.
    refs = list(ray_tpu_torch.get(g.completed(), timeout=30))
    assert [r.hex() for r in refs] == [r.hex() for r in yielded]
    assert [ray_tpu_torch.get(r, timeout=30) for r in refs] == vals


def test_streaming_yields_arrive_before_task_completes(serve_cluster):
    @ray_tpu_torch.remote
    class Gate:
        def __init__(self):
            self._open = False
        def open(self):
            self._open = True
        def is_open(self):
            return self._open

    gate = Gate.remote()

    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(gate):
        yield "first"
        while not ray_tpu_torch.get(gate.is_open.remote()):
            time.sleep(0.02)
        yield "second"

    g = gen.remote(gate)
    it = iter(g)
    # First yield is consumable while the task is parked on the gate —
    # i.e. strictly before the generator completes.
    assert ray_tpu_torch.get(next(it)) == "first"
    ray_tpu_torch.get(gate.open.remote())
    assert ray_tpu_torch.get(next(it)) == "second"
    with pytest.raises(StopIteration):
        next(it)


def test_streaming_error_propagates_after_partial_stream(serve_cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def bad():
        yield 1
        yield 2
        raise ValueError("decode exploded")

    g = bad.remote()
    it = iter(g)
    assert ray_tpu_torch.get(next(it)) == 1
    assert ray_tpu_torch.get(next(it)) == 2
    with pytest.raises(ray_tpu_torch.exceptions.TaskError, match="decode exploded"):
        while True:
            next(it)


def test_streaming_actor_async_generator(serve_cluster):
    @ray_tpu_torch.remote
    class Streamer:
        async def tokens(self, n):
            for i in range(n):
                await asyncio.sleep(0.005)
                yield i * i

    a = Streamer.remote()
    g = a.tokens.options(num_returns="streaming").remote(4)
    assert [ray_tpu_torch.get(r) for r in g] == [0, 1, 4, 9]


def test_streaming_cancel_runs_generator_finally(serve_cluster):
    @ray_tpu_torch.remote
    class Flag:
        def __init__(self):
            self.v = False
        def set(self):
            self.v = True
        def get(self):
            return self.v

    flag = Flag.remote()

    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(flag):
        try:
            for i in range(10_000):
                yield i
                time.sleep(0.01)
        finally:
            ray_tpu_torch.get(flag.set.remote())

    g = gen.remote(flag)
    it = iter(g)
    assert ray_tpu_torch.get(next(it)) == 0
    g.cancel()
    # Cancellation closes the user generator executor-side: its finally
    # block must run (that is what releases engine KV pages in serve).
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if ray_tpu_torch.get(flag.get.remote()):
            break
        time.sleep(0.05)
    assert ray_tpu_torch.get(flag.get.remote())


def test_dropped_generator_ref_frees_per_yield_extras(serve_cluster):
    """Regression (ownership gap): a reply whose generator ref was freed
    before it arrived must free the per-yield plasma extras instead of
    leaking them (they would otherwise hold directory entries and an
    executor-node copy forever)."""
    from ray_tpu_torch._private.ids import ObjectID, TaskID
    from ray_tpu_torch._private.worker import get_core

    core = get_core()
    tid = TaskID.from_random()
    ref0 = ObjectID.for_task_return(tid, 0)
    extra1 = ObjectID.for_task_return(tid, 1)
    extra2 = ObjectID.for_task_return(tid, 2)
    # ref0 deliberately NOT in core.owned — the caller freed it.
    reply = {"ok": True, "returns": [
        (ref0.hex(), "inline", b"x"),
        (extra1.hex(), "plasma", None),
        (extra2.hex(), "inline", b"y"),
    ]}

    sent = []
    orig_notify = core.gcs.notify

    async def spy(msg):
        if msg.get("type") == "object_freed":
            sent.append(msg["object_id"])
            return None
        return await orig_notify(msg)

    core.gcs.notify = spy
    try:
        done = __import__("threading").Event()

        def _run():
            core._store_task_returns(reply, [ref0])
            done.set()

        core.loop.call_soon_threadsafe(_run)
        assert done.wait(10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sent:
            time.sleep(0.02)
    finally:
        core.gcs.notify = orig_notify
    assert extra1.hex() in sent            # plasma extra freed
    assert extra1.hex() not in core.owned  # and not adopted
    assert extra2.hex() not in core.owned


# -------------------------------------------------- paged KV equivalence


def _greedy_dense(forward, params, cfg, prompt, n):
    cur = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = forward(params, torch.tensor([cur]), cfg)
            t = int(torch.argmax(logits[0, -1]))
            out.append(t)
            cur.append(t)
    return out


def test_gpt_paged_decode_matches_dense():
    from ray_tpu_torch.models.gpt import (gpt_decode_step, gpt_forward,
                                          gpt_init, gpt_prefill,
                                          init_paged_cache)

    cfg = _tiny_gpt()
    params = gpt_init(0, cfg, device="cpu")
    page = 8
    kp, vp = init_paged_cache(cfg, 32, page, device="cpu")
    prompt = [5, 17, 3, 88, 41]
    toks = torch.tensor([prompt + [0] * (8 - len(prompt))])
    pt = torch.tensor([[1, 2, 0, 0]])

    with torch.no_grad():
        logits, kp, vp = gpt_prefill(params, cfg, toks, len(prompt), kp, vp,
                                     pt)
        dense = gpt_forward(params, toks[:, : len(prompt)], cfg)
        np.testing.assert_allclose(logits[0].numpy(),
                                   dense[0, -1].float().numpy(),
                                   rtol=1e-5, atol=1e-5)

        tok, pos, out = int(torch.argmax(logits[0])), len(prompt), []
        out.append(tok)
        for _ in range(9):
            lg, kp, vp = gpt_decode_step(
                params, cfg, torch.tensor([tok]), torch.tensor([pos]), kp,
                vp, pt)
            tok = int(torch.argmax(lg[0]))
            out.append(tok)
            pos += 1
    assert out == _greedy_dense(gpt_forward, params, cfg, prompt, 10)


# ------------------------------------------------------ serve integration


def _read_http_response(sock):
    resp = b""
    while True:
        if b"\r\n\r\n" in resp:
            head, rest = resp.split(b"\r\n\r\n", 1)
            n = int([h for h in head.split(b"\r\n")
                     if h.lower().startswith(b"content-length")][0]
                    .split(b":")[1])
            if len(rest) >= n:
                return head, rest[:n]
        c = sock.recv(65536)
        if not c:
            return resp.split(b"\r\n\r\n", 1)[0], b""
        resp += c


def _post(sock, path, body: bytes, extra: str = ""):
    sock.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Type: application/json\r\n{extra}"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)


def test_serve_streaming_end_to_end(serve_cluster):
    """The acceptance path: LLMServer replica, handle + HTTP SSE clients,
    first token on the wire before the stream completes, streamed tokens
    equal to the unary (drained) result."""
    from ray_tpu_torch.serve.engine import EngineConfig, LLMServer

    ecfg = EngineConfig(model="gpt", model_config=_tiny_gpt(), page_size=8,
                        num_pages=64, max_batch=8, max_prompt_len=32,
                        max_new_tokens=16, device="cpu")
    dep = serve.deployment(name="llm", max_concurrent_queries=16,
                           ray_actor_options={"num_cpus": 0.1})(LLMServer)
    handle = serve.run(dep.bind(ecfg))
    payload = {"tokens": [5, 17, 3], "max_new_tokens": 8}

    # Streaming handle: per-token ObjectRefs as they decode.
    toks = [ray_tpu_torch.get(r) for r in handle.remote_stream(payload)]
    assert len(toks) == 8
    # Unary handle call drains the same generator to a list.
    assert ray_tpu_torch.get(handle.remote(payload), timeout=60) == toks

    url = serve.start_http()
    host, port = url.split("//")[1].split(":")
    s = socket.create_connection((host, int(port)), timeout=60)
    try:
        _post(s, "/llm", json.dumps({**payload, "stream": True}).encode())
        buf = b""
        saw_token_before_end = False
        # Read through the chunked TERMINATOR, not just the end event —
        # stopping early would leave terminator bytes in the socket to
        # pollute the next keep-alive response on this connection.
        while b"event: end" not in buf or not buf.endswith(b"0\r\n\r\n"):
            c = s.recv(4096)
            assert c, f"connection closed early: {buf!r}"
            buf += c
            if b"data: " in buf and b"event: end" not in buf:
                saw_token_before_end = True
        assert saw_token_before_end
        assert b"Transfer-Encoding: chunked" in buf
        assert b"text/event-stream" in buf
        events = [l for l in buf.replace(b"\r\n", b"\n").split(b"\n")
                  if l.startswith(b"data: ")]
        assert [json.loads(e[6:]) for e in events][:-1] == toks
        # Keep-alive: the same connection serves a unary request next.
        _post(s, "/llm", json.dumps(payload).encode())
        head, body = _read_http_response(s)
        assert b"200" in head.split(b"\r\n")[0]
        assert json.loads(body)["result"] == toks
    finally:
        s.close()


def test_http_client_disconnect_cancels_stream(serve_cluster):
    """A client that walks away mid-stream must cancel the replica-side
    generator (releasing engine slots/pages), not leave it producing into
    the void."""
    @serve.deployment(name="slowgen", ray_actor_options={"num_cpus": 0.1})
    class SlowGen:
        def __init__(self):
            self.closed = 0
        async def __call__(self, payload):
            try:
                for i in range(200):
                    await asyncio.sleep(0.02)
                    yield i
            except BaseException:
                self.closed += 1
                raise
        def stats(self):
            return self.closed

    handle = serve.run(SlowGen.bind())
    url = serve.start_http()
    host, port = url.split("//")[1].split(":")
    s = socket.create_connection((host, int(port)), timeout=30)
    _post(s, "/slowgen", json.dumps({"stream": True}).encode())
    buf = b""
    while b"data: " not in buf:
        buf += s.recv(4096)
    s.close()                                   # vanish mid-stream
    deadline = time.monotonic() + 30
    closed = 0
    while time.monotonic() < deadline:
        closed = ray_tpu_torch.get(handle.method("stats").remote(), timeout=30)
        if closed:
            break
        time.sleep(0.1)
    assert closed == 1


def test_http_robustness_malformed_and_oversized(serve_cluster):
    url = serve.start_http()
    host, port = url.split("//")[1].split(":")

    # Malformed content-length: clean 400, no reader hang.
    s = socket.create_connection((host, int(port)), timeout=10)
    s.sendall(b"POST /x HTTP/1.1\r\nHost: x\r\nContent-Length: zork\r\n\r\n")
    head, _ = _read_http_response(s)
    assert b"400" in head.split(b"\r\n")[0]
    s.close()

    # Oversized body: 413 before reading the body.
    s = socket.create_connection((host, int(port)), timeout=10)
    s.sendall(b"POST /x HTTP/1.1\r\nHost: x\r\n"
              b"Content-Length: 99999999999\r\n\r\n")
    head, _ = _read_http_response(s)
    assert b"413" in head.split(b"\r\n")[0]
    s.close()

    # Garbage request line: 400.
    s = socket.create_connection((host, int(port)), timeout=10)
    s.sendall(b"NONSENSE\r\n\r\n")
    head, _ = _read_http_response(s)
    assert b"400" in head.split(b"\r\n")[0]
    s.close()
