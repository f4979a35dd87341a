"""Serving-fleet resilience: circuit breaking, bounded retry, end-to-end
deadlines, and mid-stream failover.

Reference analogs: Ray Serve replica health gating + router retry,
Envoy/Finagle-style consecutive-failure breakers with half-open probes.
The chaos-scale version (3 replicas x 16 SSE sessions, kill + rolling
restart mid-storm) lives in test_serve_fleet.py; this file is the tier-1
coverage: the state machines, the deadline plumbing down to the engine's
KV pages, and a single-kill bit-match failover.

The port's runtime under ``test_serve_resilience.py``'s cases, one for one.
"""

import asyncio
import json
import socket
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import metrics as serve_metrics
from ray_tpu_torch.serve import resilience
from ray_tpu_torch.serve.http_ingress import HTTPIngress
from ray_tpu_torch.util import fault_injection


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=16)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _tiny_gpt():
    from ray_tpu_torch.models.gpt import GPTConfig
    # f32 end to end: greedy argmax is exactly reproducible, which the
    # bit-match failover assertion below depends on.
    return GPTConfig(vocab_size=97, max_seq_len=96, num_layers=2,
                     num_heads=4, embed_dim=32, dtype=torch.float32,
                     attention="dense", remat=False)


def _greedy_dense(prompt, n):
    """Dense greedy reference with the same deterministic params every
    replica initialises (seed 0)."""
    from ray_tpu_torch.models.gpt import gpt_forward, gpt_init
    cfg = _tiny_gpt()
    params = gpt_init(0, cfg, device="cpu")
    cur = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = gpt_forward(params, torch.tensor([cur]), cfg)
            t = int(torch.argmax(logits[0, -1]))
            out.append(t)
            cur.append(t)
    return out


def _throttled_llm(name, delay_s, num_replicas=1):
    """LLMServer wrapper pacing the token stream so kills and deadlines
    land mid-generation deterministically on CPU."""
    from ray_tpu_torch.serve.engine import EngineConfig

    @serve.deployment(name=name, num_replicas=num_replicas,
                      max_concurrent_queries=8,
                      ray_actor_options={"num_cpus": 0.1})
    class ThrottledLLM:
        def __init__(self, ecfg, delay):
            from ray_tpu_torch.serve.engine import LLMServer
            self._inner = LLMServer(ecfg)
            self._delay = delay

        async def __call__(self, payload):
            async for tok in self._inner(payload):
                await asyncio.sleep(self._delay)
                yield tok

        def stats(self):
            return self._inner.stats()

    ecfg = EngineConfig(model="gpt", model_config=_tiny_gpt(), page_size=8,
                        num_pages=64, max_batch=8, max_prompt_len=48,
                        max_new_tokens=48, device="cpu")
    return ThrottledLLM.bind(ecfg, delay_s)


class _Rep:
    def __init__(self, rid):
        self._actor_id = rid


# ------------------------------------------------------- state machines


def test_circuit_breaker_opens_half_opens_and_closes():
    opened = []
    cb = resilience.CircuitBreaker(threshold=3, cooldown_s=0.2,
                                   on_open=opened.append)
    assert cb.try_admit("a")                     # unknown key is CLOSED
    cb.record_failure("a")
    cb.record_failure("a")
    assert cb.state("a") == resilience.CB_CLOSED
    cb.record_failure("a")                       # threshold -> ejected
    assert cb.state("a") == resilience.CB_OPEN
    assert opened == ["a"]
    assert not cb.try_admit("a")
    time.sleep(0.25)                             # cooldown elapses
    assert cb.state("a") == resilience.CB_HALF_OPEN
    assert cb.try_admit("a")                     # the single probe
    assert not cb.try_admit("a")                 # probe in flight
    cb.record_success("a")                       # probe passed
    assert cb.state("a") == resilience.CB_CLOSED
    assert cb.snapshot() == {}

    # A failed probe re-opens for another full cooldown.
    for _ in range(3):
        cb.record_failure("b")
    time.sleep(0.25)
    assert cb.try_admit("b")
    cb.record_failure("b")
    assert cb.state("b") == resilience.CB_OPEN
    assert not cb.try_admit("b")


def test_circuit_breaker_probe_slot_cannot_wedge():
    """A probe slot reserved by a caller that never resolves it (picked
    but not sent) expires after another cooldown instead of refusing the
    replica forever."""
    cb = resilience.CircuitBreaker(threshold=1, cooldown_s=0.15)
    cb.record_failure("c")
    time.sleep(0.2)
    assert cb.try_admit("c")                     # reserve the probe...
    assert not cb.try_admit("c")                 # ...and abandon it
    time.sleep(0.2)
    assert cb.try_admit("c")                     # reservation expired


def test_circuit_breaker_filter_prefers_closed_replicas():
    cb = resilience.CircuitBreaker(threshold=1, cooldown_s=0.1)
    reps = [_Rep("x"), _Rep("y")]
    cb.record_failure("x")
    time.sleep(0.15)                             # x is probe-eligible
    # A closed replica exists: the probe is NOT spent on x.
    assert [r._actor_id for r in cb.filter(reps)] == ["y"]
    assert cb.select(reps, 7)._actor_id == "y"
    # No closed replica left (y excluded): now x's probe is spent.
    assert [r._actor_id for r in cb.filter(reps, exclude={"y"})] == ["x"]
    # Everything excluded or ejected -> None, callers 503.
    assert cb.select(reps, 0, exclude={"x", "y"}) is None
    cb.forget_missing(["y"])
    assert cb.state("x") == resilience.CB_CLOSED  # state dropped


def test_retry_policy_budget_and_deadline_clamp():
    p = resilience.RetryPolicy(budget=2, base_s=0.1, cap_s=0.5)
    assert p.can_retry()
    assert 0.0 <= p.next_backoff_s() <= 0.1
    assert p.can_retry()
    assert 0.0 <= p.next_backoff_s() <= 0.2      # window doubles
    assert not p.can_retry()                     # budget spent

    # Backoff never sleeps past the request's remaining deadline...
    p2 = resilience.RetryPolicy(budget=1, base_s=10.0, cap_s=10.0)
    assert p2.next_backoff_s(time.time() + 0.05) <= 0.06
    # ...and an expired deadline means no sleep at all.
    p3 = resilience.RetryPolicy(budget=1, base_s=10.0, cap_s=10.0)
    assert p3.next_backoff_s(time.time() - 1.0) == 0.0


def test_error_classification():
    from ray_tpu_torch import exceptions as rex
    # System failures another replica can absorb: retryable.
    assert resilience.is_retryable_error(rex.ActorDiedError("gone"))
    assert resilience.is_retryable_error(rex.ActorUnavailableError("brb"))
    assert resilience.is_retryable_error(rex.WorkerCrashedError("boom"))
    assert resilience.is_retryable_error(ConnectionResetError())
    assert resilience.is_retryable_error(resilience.DecodeStalled("quiet"))
    # A dial that raced the GCS death record surfaces as a TaskError
    # around the connection failure — still a system error, retryable.
    assert resilience.is_retryable_error(
        rex.TaskError(ConnectionRefusedError(111, "refused")))
    # Handler exceptions recur deterministically: not retryable.
    assert not resilience.is_retryable_error(
        rex.TaskError(ValueError("bad payload")))
    assert not resilience.is_retryable_error(ValueError("nope"))
    # Deadline expiry, raw or TaskError-wrapped, is terminal (504).
    dead = resilience.DeadlineExceeded("late")
    assert resilience.is_deadline_error(dead)
    assert not resilience.is_retryable_error(dead)
    wrapped = rex.TaskError(dead, "tb")
    assert resilience.is_deadline_error(wrapped)
    assert not resilience.is_retryable_error(wrapped)


def test_deadline_contextvar_roundtrip():
    assert resilience.current_deadline() is None
    assert resilience.deadline_remaining() is None
    tok = resilience.set_deadline(time.time() + 5.0)
    try:
        assert 4.0 < resilience.deadline_remaining() <= 5.0
    finally:
        resilience.reset_deadline(tok)
    assert resilience.current_deadline() is None


def test_resume_payload_token_math():
    # Token-generation payloads resume by re-prefill: prompt + delivered,
    # remaining budget, zero items skipped.
    p, skip = HTTPIngress._resume_payload(
        {"tokens": [1, 2], "max_new_tokens": 10, "stream": True}, [7, 8, 9])
    assert p["tokens"] == [1, 2, 7, 8, 9]
    assert p["max_new_tokens"] == 7
    assert p["stream"] is True and skip == 0
    # Opaque payloads replay and skip what the client already has.
    p, skip = HTTPIngress._resume_payload({"text": "hi"}, ["a", "b"])
    assert p == {"text": "hi"} and skip == 2
    # Non-int delivered items can't be re-prefilled: replay path.
    _, skip = HTTPIngress._resume_payload(
        {"tokens": [1], "max_new_tokens": 4}, ["x"])
    assert skip == 1


def test_ingress_controller_reresolve_backoff():
    """Controller loss backs off exponentially (capped) instead of
    hammering the GCS with a lookup per request."""
    ing = HTTPIngress()
    delays = []
    for _ in range(8):
        before = time.monotonic()
        ing._ctrl_backoff()
        delays.append(ing._ctrl_retry_at - before)
    assert delays[0] <= 0.6
    assert delays[1] > delays[0]
    assert delays[-1] == pytest.approx(8.0, abs=0.1)   # capped
    # While the gate is closed, resolution fails fast without a lookup.
    with pytest.raises(RuntimeError, match="backing off"):
        asyncio.run(ing._controller())


def test_serve_metrics_flow_to_node_stats_shape():
    """Serve counters are plain numbers keyed by the exported names — the
    contract raylet._collect_node_stats and the GCS fold rely on."""
    serve_metrics.reset()
    serve_metrics.bump("streams_resumed")
    serve_metrics.bump("drain_handoffs", 3)
    st = serve_metrics.stats()
    assert st["streams_resumed"] == 1
    assert st["drain_handoffs"] == 3
    assert set(st) == set(serve_metrics.COUNTER_NAMES)
    from ray_tpu_torch._private.gcs import GcsServer
    for name in serve_metrics.COUNTER_NAMES:
        assert name in GcsServer._FOLDED_COUNTERS
    serve_metrics.reset()


def test_stall_replica_decode_fault_hook():
    fault_injection.set_spec(
        stall_replica_decode={"after": 2, "stall_s": 1.5})
    try:
        assert fault_injection.stall_replica_decode_s() == 0.0
        assert fault_injection.stall_replica_decode_s() == 1.5   # Nth step
        assert fault_injection.stall_replica_decode_s() == 0.0   # one-shot
    finally:
        fault_injection.clear_spec()


class _Writer:
    """Stand-in for the ingress's StreamWriter: keeps what is written."""

    def __init__(self):
        self.buf = b""

    def write(self, data):
        self.buf += data

    async def drain(self):
        pass


def test_engine_deadline_is_not_a_timeout_and_the_ingress_answers_504():
    """An expired deadline raised by the port's engine is
    resilience.DeadlineExceeded, a plain Exception.  Were it a TimeoutError
    (which asyncio.TimeoutError is on Python 3.11+), the ingress's stall
    clause would take it for a wedged replica and fail the stream over;
    it must answer 504 on the first replica instead."""
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(model="gpt", model_config=_tiny_gpt(), page_size=8,
                        num_pages=64, max_batch=4, max_prompt_len=32,
                        max_new_tokens=32, device="cpu")

    async def run():
        eng = InferenceEngine(ecfg)
        # The engine raises the deadline itself ...
        with pytest.raises(Exception) as info:
            async for _ in eng.generate([5, 17, 3], 32,
                                        deadline=time.time() - 1.0):
                pass
        assert type(info.value) is resilience.DeadlineExceeded
        assert not isinstance(info.value, TimeoutError)

        # ... and reaches the ingress unwrapped: a handler-side deadline
        # (here 0.3 s) expires while the request itself has none.
        calls = []

        class _Stream:
            def __init__(self):
                self._it = eng.generate([5, 17, 3], 32,
                                        deadline=time.time() + 0.3)

            def __aiter__(self):
                return self

            async def __anext__(self):
                await asyncio.sleep(0.05)      # a token every 50 ms
                return await self._it.__anext__()

            def cancel(self):
                pass

        async def call_stream(name, payload, deadline=None, exclude=None):
            calls.append(name)
            return _Stream(), f"replica-{len(calls)}"

        serve_metrics.reset()
        ing = HTTPIngress(stall_timeout_s=30.0)
        ing._call_stream = call_stream
        w = _Writer()
        await ing._dispatch_stream(
            w, "llm", {"tokens": [5, 17, 3], "max_new_tokens": 32,
                       "stream": True})
        eng.close()
        return w.buf, calls

    buf, calls = asyncio.run(run())
    assert b"data: " in buf                   # tokens went out first
    errors = [json.loads(line[6:]) for line in
              buf.replace(b"\r\n", b"\n").split(b"\n")
              if line.startswith(b"data: {")]
    assert errors and errors[-1]["code"] == 504, buf[-300:]
    assert calls == ["llm"], "the deadline was failed over"
    assert serve_metrics.stats()["router_retries"] == 0
    serve_metrics.reset()


# ------------------------------------------------------- live plumbing


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


def _connect(url, timeout=120):
    host, port = url.split("//")[1].split(":")
    return socket.create_connection((host, int(port)), timeout=timeout)


def _replica_actors(deployment):
    from ray_tpu_torch.util import state
    return [a for a in state.list_actors()
            if (a.get("name") or "").startswith(f"_serve:{deployment}:")
            and a.get("state") == "ALIVE"]


def test_deadline_expired_at_ingress_is_504(serve_cluster):
    serve.run(_throttled_llm("dllm", 0.05))
    url = serve.start_http()
    s = _connect(url)
    try:
        # Already-expired deadline: refused at the router, no replica
        # work, no retry (retrying cannot un-expire a deadline).
        _post(s, "/dllm", json.dumps(
            {"tokens": [5, 17, 3], "max_new_tokens": 4,
             "deadline_s": -1.0}).encode())
        head, body = _read_http_response(s)
        assert b"504" in head.split(b"\r\n")[0], head
    finally:
        s.close()


def test_deadline_expiry_frees_kv_pages_and_spares_batch(serve_cluster):
    """A request whose deadline expires mid-decode 504s, its KV pages
    return to the pool, and a concurrent request in the same batch is
    untouched."""
    handle = serve.run(_throttled_llm("dllm", 0.05))
    url = serve.start_http()
    warm = {"tokens": [5, 17, 3], "max_new_tokens": 2}
    ray_tpu_torch.get(handle.remote(warm), timeout=180)      # compile
    baseline = ray_tpu_torch.get(handle.method("stats").remote(),
                           timeout=60)["free_pages"]

    # A healthy request sharing the continuous batch with the doomed one.
    good_ref = handle.remote({"tokens": [5, 17, 3], "max_new_tokens": 16})
    time.sleep(0.1)

    s = _connect(url)
    try:
        # 48 tokens at 50ms each can't finish in 0.4s: the deadline
        # expires replica-side, decode cancels, pages free.
        _post(s, "/dllm", json.dumps(
            {"tokens": [5, 17, 3], "max_new_tokens": 48,
             "deadline_s": 0.4}).encode())
        head, body = _read_http_response(s)
        assert b"504" in head.split(b"\r\n")[0], (head, body)
    finally:
        s.close()

    # The batch-mate was unharmed — bit-exact greedy result.
    assert ray_tpu_torch.get(good_ref, timeout=120) == _greedy_dense([5, 17, 3], 16)

    # The expired request's pages all came back.
    deadline = time.monotonic() + 30
    free = -1
    while time.monotonic() < deadline:
        free = ray_tpu_torch.get(handle.method("stats").remote(),
                           timeout=60)["free_pages"]
        if free == baseline:
            break
        time.sleep(0.2)
    assert free == baseline, f"leaked KV pages: {free} != {baseline}"


def test_stream_failover_after_kill_is_bit_identical(serve_cluster):
    """The tentpole acceptance: kill the serving replica mid-SSE-stream;
    the ingress resumes on the surviving replica by re-prefilling
    prompt + delivered tokens, and the client's total token sequence is
    bit-identical to an uninterrupted greedy run."""
    from ray_tpu_torch.actor import ActorHandle

    prompt, n = [5, 17, 3], 40
    # 150ms/token -> ~6s of stream after the first token: the probe-and-
    # kill below lands mid-stream with seconds to spare.
    serve.run(_throttled_llm("fllm", 0.15, num_replicas=2))
    url = serve.start_http()
    s = _connect(url)
    try:
        _post(s, "/fllm", json.dumps(
            {"tokens": prompt, "max_new_tokens": n,
             "stream": True}).encode())
        buf = b""
        while buf.count(b"data: ") < 6:          # stream is mid-flight
            c = s.recv(4096)
            assert c, f"stream closed early: {buf!r}"
            buf += c

        # Find the replica actually serving this stream and SIGKILL it.
        busy_id, busy_qlen = None, -1
        for a in _replica_actors("fllm"):
            qlen = ray_tpu_torch.get(ActorHandle(
                a["actor_id"], "Replica").queue_len.remote(), timeout=30)
            if qlen > busy_qlen:
                busy_id, busy_qlen = a["actor_id"], qlen
        assert busy_qlen >= 1, "no replica reports the in-flight stream"
        fault_injection.kill_replica(actor_id=busy_id)

        # The SSE stream must finish cleanly — no error event, no break.
        while b"event: end" not in buf or not buf.endswith(b"0\r\n\r\n"):
            c = s.recv(4096)
            assert c, f"stream dropped after kill: {buf[-200:]!r}"
            buf += c
        assert b"event: error" not in buf, buf
        events = [l for l in buf.replace(b"\r\n", b"\n").split(b"\n")
                  if l.startswith(b"data: ")]
        toks = [json.loads(e[6:]) for e in events][:-1]  # drop end's data
        assert toks == _greedy_dense(prompt, n)
    finally:
        s.close()

    # The failover was counted where the ingress did it.
    ing = ray_tpu_torch.get_actor("_serve_http")
    st = ray_tpu_torch.get(ing.stats.remote(), timeout=30)
    assert st["streams_resumed"] >= 1, st
    assert st["router_retries"] >= 1, st


def test_rolling_restart_replaces_every_replica(serve_cluster):
    @serve.deployment(name="echo2", num_replicas=2,
                      ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __call__(self, payload):
            return {"echo": payload}

    handle = serve.run(Echo.bind())
    assert ray_tpu_torch.get(handle.remote({"x": 1}), timeout=60) == \
        {"echo": {"x": 1}}
    deadline = time.monotonic() + 60
    while True:
        before = {a["actor_id"] for a in _replica_actors("echo2")}
        if len(before) == 2:
            break
        assert time.monotonic() < deadline, before
        time.sleep(0.3)

    res = serve.rolling_restart("echo2")
    assert res["deployment"] == "echo2"
    assert res["replaced"] == 2 and res["skipped"] == 0, res

    # The victims' kills are async (the controller fire-and-forgets
    # kill_actor); under load the last victim can linger ALIVE in the
    # GCS for a moment — poll until the fleet is exactly the fresh pair.
    deadline = time.monotonic() + 60
    while True:
        after = {a["actor_id"] for a in _replica_actors("echo2")}
        if len(after) == 2 and after.isdisjoint(before):
            break
        assert time.monotonic() < deadline, (before, after)
        time.sleep(0.3)
    # Still serving through the fresh fleet.
    assert ray_tpu_torch.get(handle.remote({"x": 2}), timeout=60) == \
        {"echo": {"x": 2}}


def test_serve_totals_merges_worker_counters(serve_cluster):
    """Driver/worker-side bumps reach state.serve_totals() through the
    user-metrics pipe (flush period 1s) — the same path the controller's
    drain_handoffs and the ingress counters ride."""
    from ray_tpu_torch.util import state
    totals = state.serve_totals()
    assert set(serve_metrics.COUNTER_NAMES) <= set(totals)
    base = totals["router_retries"]
    serve_metrics.bump("router_retries", 2)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if state.serve_totals()["router_retries"] >= base + 2:
            break
        time.sleep(0.3)
    assert state.serve_totals()["router_retries"] >= base + 2
