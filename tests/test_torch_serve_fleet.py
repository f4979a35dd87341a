"""Serving-fleet chaos: SSE storm across 3 replicas with a mid-storm
replica kill, a full rolling restart, and a stalled-decode failover —
zero dropped streams, every token sequence bit-identical to the greedy
reference.

Run via ``scripts/run_chaos.sh serve-fleet`` (3x under CPU burners).

Each test owns its cluster: RT_SERVE_* knobs and RT_FAULT_INJECTION ride
in via ``_worker_env`` so the controller / ingress / replica worker
processes pick them up from their environment.

The port's runtime under ``test_serve_fleet.py``'s cases, one for one.
"""

import contextlib
import json
import socket
import threading
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.util import fault_injection

pytestmark = [pytest.mark.slow, pytest.mark.chaos, pytest.mark.serve_fleet]


@contextlib.contextmanager
def _cluster(extra_env):
    env = dict(extra_env)
    info = ray_tpu_torch.init(num_cpus=8, _worker_env=env)
    try:
        yield info
    finally:
        with contextlib.suppress(Exception):
            serve.shutdown()
        ray_tpu_torch.shutdown()


def _tiny_gpt():
    from ray_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=97, max_seq_len=96, num_layers=2,
                     num_heads=4, embed_dim=32, dtype=torch.float32,
                     attention="dense", remat=False)


def _ecfg():
    from ray_tpu_torch.serve.engine import EngineConfig
    return EngineConfig(model="gpt", model_config=_tiny_gpt(), page_size=8,
                        num_pages=128, max_batch=8, max_prompt_len=48,
                        max_new_tokens=48, device="cpu")


_REFS = {}


def _greedy_dense(prompt, n):
    key = (tuple(prompt), n)
    if key not in _REFS:
        from ray_tpu_torch.models.gpt import gpt_forward, gpt_init
        cfg = _tiny_gpt()
        params = gpt_init(0, cfg, device="cpu")
        cur, out = list(prompt), []
        with torch.no_grad():
            for _ in range(n):
                logits = gpt_forward(params, torch.tensor([cur]), cfg)
                t = int(torch.argmax(logits[0, -1]))
                out.append(t)
                cur.append(t)
        _REFS[key] = out
    return _REFS[key]


def _throttled_llm(name, delay_s, num_replicas):
    @serve.deployment(name=name, num_replicas=num_replicas,
                      max_concurrent_queries=8,
                      ray_actor_options={"num_cpus": 0.1})
    class ThrottledLLM:
        def __init__(self, ecfg, delay):
            from ray_tpu_torch.serve.engine import LLMServer
            self._inner = LLMServer(ecfg)
            self._delay = delay

        async def __call__(self, payload):
            import asyncio
            # Per-request override so one test can mix fast streams (bulk
            # of the storm) with slow ones that provably outlive a drain
            # deadline.  The ingress snapshots the payload before it
            # reaches us, so the override survives failover re-prefills.
            delay = float(payload.pop("delay_s", 0) or self._delay)
            async for tok in self._inner(payload):
                await asyncio.sleep(delay)
                yield tok

        def stats(self):
            return self._inner.stats()

    return ThrottledLLM.bind(_ecfg(), delay_s)


def _connect(url, timeout=300):
    host, port = url.split("//")[1].split(":")
    return socket.create_connection((host, int(port)), timeout=timeout)


def _stream_one(url, route, prompt, n, results, flags, idx, extra=None):
    """One SSE session: POST, read every token through the chunked
    terminator, record the token list (or the failure)."""
    try:
        s = _connect(url)
        try:
            payload = {"tokens": prompt, "max_new_tokens": n,
                       "stream": True}
            payload.update(extra or {})
            body = json.dumps(payload).encode()
            s.sendall(f"POST {route} HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            buf = b""
            while b"event: end" not in buf or not buf.endswith(b"0\r\n\r\n"):
                c = s.recv(4096)
                if not c:
                    raise AssertionError(
                        f"stream dropped: {buf[-300:]!r}")
                buf += c
                if b"data: " in buf:
                    flags[idx] = True
            if b"event: error" in buf:
                raise AssertionError(f"error event: {buf[-400:]!r}")
            events = [l for l in buf.replace(b"\r\n", b"\n").split(b"\n")
                      if l.startswith(b"data: ")]
            results[idx] = [json.loads(e[6:]) for e in events][:-1]
        finally:
            s.close()
    except BaseException as e:  # noqa: BLE001 - reported to the main thread
        results[idx] = e


def _launch(url, route, prompts, n, results, flags, offset, extra=None):
    threads = []
    for i, p in enumerate(prompts):
        t = threading.Thread(target=_stream_one,
                             args=(url, route, p, n, results, flags,
                                   offset + i, extra), daemon=True)
        t.start()
        threads.append(t)
    return threads


def test_fleet_kill_and_rolling_restart_zero_loss():
    """The acceptance storm: 16 SSE sessions over 3 replicas, one replica
    SIGKILLed mid-storm, then a full rolling restart under a second wave
    — zero dropped streams, all bit-exact, counters on /api/metrics."""
    with _cluster({"RT_SERVE_DRAIN_S": "0.5",
                   "RT_SERVE_STALL_S": "15"}) as info:
        serve.run(_throttled_llm("fleet", 0.08, num_replicas=3))
        url = serve.start_http()
        n_a, n_b = 16, 12
        # tokens_b bounded by the resume path: a late failover re-prefills
        # prompt(3) + delivered(<= tokens_b - 1), which must stay within
        # the engine's max_prompt_len=48.
        tokens_a, tokens_b = 32, 40
        prompts_a = [[5, 17, 3 + (i % 8)] for i in range(n_a)]
        prompts_b = [[7, 11, 2 + (i % 8)] for i in range(n_b)]
        results = [None] * (n_a + n_b)
        flags = [False] * (n_a + n_b)

        threads = _launch(url, "/fleet", prompts_a, tokens_a,
                          results, flags, 0)
        # Wave A fully mid-flight (every session saw >= 1 token) before
        # the chaos starts.
        deadline = time.monotonic() + 180
        while not all(flags[:n_a]):
            assert time.monotonic() < deadline, \
                f"storm never got rolling: {flags}"
            time.sleep(0.1)

        # Kill one serving replica under the storm (SIGKILL, no drain).
        killed = fault_injection.kill_replica("fleet", index=0)
        assert killed["actor_id"]

        # Second wave + rolling restart of the whole fleet underneath it.
        # Wave B runs slow (0.75s/token => ~30s/stream) and must be
        # mid-flight BEFORE the rollout starts, so streams are still
        # live when the first victim's RT_SERVE_DRAIN_S=0.5 drain
        # deadline expires — that is what makes drain_handoffs count.
        threads += _launch(url, "/fleet", prompts_b, tokens_b,
                           results, flags, n_a, extra={"delay_s": 0.75})
        deadline = time.monotonic() + 180
        while not all(flags[n_a:]):
            assert time.monotonic() < deadline, \
                f"wave B never got rolling: {flags}"
            time.sleep(0.1)
        res = serve.rolling_restart("fleet")
        assert res["replaced"] + res["skipped"] >= 3, res

        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "streams hung"

        # ZERO dropped streams, every one bit-identical to the greedy
        # reference — mid-kill, mid-restart, or untouched alike.
        for i, (p, n) in enumerate(
                [(p, tokens_a) for p in prompts_a]
                + [(p, tokens_b) for p in prompts_b]):
            r = results[i]
            if isinstance(r, BaseException):
                raise AssertionError(f"stream {i} failed: {r}") from r
            assert r == _greedy_dense(p, n), f"stream {i} diverged"

        # The chaos was actually exercised and counted.
        ing = ray_tpu_torch.get_actor("_serve_http")
        st = ray_tpu_torch.get(ing.stats.remote(), timeout=30)
        assert st["streams_resumed"] >= 1, st
        assert st["router_retries"] >= 1, st

        # Counters reach the folded cluster totals and the dashboard
        # scrape (worker-metrics flush is periodic: poll briefly).
        from ray_tpu_torch.util import state
        wanted = ("streams_resumed", "router_retries", "drain_handoffs")
        deadline = time.monotonic() + 30
        totals = {}
        while time.monotonic() < deadline:
            totals = state.serve_totals()
            if all(totals.get(k, 0) >= 1 for k in wanted):
                break
            time.sleep(0.5)
        for k in wanted:
            assert totals.get(k, 0) >= 1, (k, totals)

        dash = info.get("dashboard_address")
        assert dash, f"no dashboard address in init info: {info}"
        body = ""
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            body = urllib.request.urlopen(
                f"http://{dash}/api/metrics", timeout=10).read().decode()
            if all(f"ray_tpu_{k}" in body for k in wanted):
                break
            time.sleep(0.5)
        for k in wanted:
            assert f"ray_tpu_{k}" in body, \
                f"{k} missing from /api/metrics"


def test_stalled_decode_fails_over_bit_identical():
    """A replica whose decode loop wedges (fault: 30th step stalls 60s)
    keeps its actor ALIVE — the ingress's stall detector must fail the
    stream over anyway, and the resumed tail must be bit-exact."""
    from ray_tpu_torch.serve.engine import LLMServer

    env = fault_injection.env_for(
        stall_replica_decode={"after": 30, "stall_s": 60})
    # The stall threshold must exceed cold-start TTFT (first token waits
    # on the replica's model build) or the detector false-positives and
    # ejects healthy replicas — 10s clears the build on a loaded box and
    # still beats the 60s wedge by far.
    env["RT_SERVE_STALL_S"] = "10"
    with _cluster(env):
        dep = serve.deployment(name="sllm", num_replicas=2,
                               max_concurrent_queries=8,
                               ray_actor_options={"num_cpus": 0.1})(
                                   LLMServer)
        serve.run(dep.bind(_ecfg()))
        url = serve.start_http()
        prompt, n = [5, 17, 3], 40
        s = _connect(url, timeout=120)
        try:
            body = json.dumps({"tokens": prompt, "max_new_tokens": n,
                               "stream": True}).encode()
            s.sendall(f"POST /sllm HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            buf = b""
            while b"event: end" not in buf or not buf.endswith(b"0\r\n\r\n"):
                c = s.recv(4096)
                assert c, f"stream dropped: {buf[-300:]!r}"
                buf += c
            assert b"event: error" not in buf, buf[-400:]
            events = [l for l in buf.replace(b"\r\n", b"\n").split(b"\n")
                      if l.startswith(b"data: ")]
            toks = [json.loads(e[6:]) for e in events][:-1]
            assert toks == _greedy_dense(prompt, n)
        finally:
            s.close()

        ing = ray_tpu_torch.get_actor("_serve_http")
        st = ray_tpu_torch.get(ing.stats.remote(), timeout=30)
        assert st["streams_resumed"] >= 1, st
