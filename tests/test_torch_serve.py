"""Serve: controller reconciliation, routing, batching, HTTP ingress.

Reference analogs: python/ray/serve/tests/ (test_deploy, test_batching,
test_autoscaling_policy, test_standalone http).

The port's runtime under ``test_serve.py``'s cases, one for one.
"""

import json
import os
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_cluster():
    # Two fake cards for the GPU cases at the end; the reference's cases
    # ask for none.
    ray_tpu_torch.init(num_cpus=16, resources={"GPU": 2})
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_deploy_and_call(serve_cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.1})
    class Doubler:
        def __call__(self, x):
            return 2 * x

    h = serve.run(Doubler.bind())
    results = ray_tpu_torch.get([h.remote(i) for i in range(20)])
    assert results == [2 * i for i in range(20)]
    st = serve.status()
    assert st["Doubler"]["running"] == 2


def test_function_deployment_and_methods(serve_cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Calc:
        def __call__(self, x):
            return x + 1

        def square(self, x):
            return x * x

    h = serve.run(Calc.bind())
    assert ray_tpu_torch.get(h.remote(41)) == 42
    assert ray_tpu_torch.get(h.method("square").remote(7)) == 49


def test_scale_up_down(serve_cluster):
    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.1})
    class S:
        def __call__(self, x):
            return x

    serve.run(S.bind())
    assert serve.status()["S"]["running"] == 1
    serve.run(S.options(num_replicas=3).bind())
    assert serve.status()["S"]["running"] == 3
    serve.run(S.options(num_replicas=1).bind())
    deadline = time.monotonic() + 30
    while serve.status()["S"]["running"] != 1:
        assert time.monotonic() < deadline
        time.sleep(0.3)


def test_batching(serve_cluster):
    @serve.deployment(max_concurrent_queries=16,
                      ray_actor_options={"num_cpus": 0.1})
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [x * 10 for x in items]

        async def __call__(self, x):
            return await self.handle(x)

        def sizes(self):
            return self.batch_sizes

    h = serve.run(Batched.bind())
    refs = [h.remote(i) for i in range(16)]
    assert sorted(ray_tpu_torch.get(refs)) == [i * 10 for i in range(16)]
    sizes = ray_tpu_torch.get(h.method("sizes").remote())
    assert sum(sizes) == 16
    # Concurrent submission must have produced at least one real batch.
    assert max(sizes) > 1, sizes


def test_replica_recovery(serve_cluster):
    """Controller replaces a killed replica (deployment_state reconcile)."""
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.1})
    class R:
        def __call__(self, x):
            return x

    h = serve.run(R.bind())
    # Kill one replica out from under the controller.
    victim = ray_tpu_torch.get(
        serve._controller().get_replicas.remote("R"))[0]
    ray_tpu_torch.kill(victim)
    deadline = time.monotonic() + 60
    while True:
        st = serve.status()["R"]
        reps = ray_tpu_torch.get(serve._controller().get_replicas.remote("R"))
        live = 0
        for r in reps:
            try:
                ray_tpu_torch.get(r.ping.remote(), timeout=5)
                live += 1
            except Exception:
                pass
        if live == 2:
            break
        assert time.monotonic() < deadline, "replica never replaced"
        time.sleep(0.5)
    assert ray_tpu_torch.get(h.remote(5)) == 5


def test_http_ingress(serve_cluster):
    @serve.deployment(route_prefix="/echo",
                      ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __call__(self, payload):
            return {"echo": payload}

    serve.run(Echo.bind())
    base = serve.start_http()
    # Routes propagate via the ingress refresh loop.
    deadline = time.monotonic() + 30
    while True:
        with urllib.request.urlopen(f"{base}/-/routes", timeout=10) as r:
            routes = json.loads(r.read())
        if "/echo" in routes:
            break
        assert time.monotonic() < deadline
        time.sleep(0.3)

    req = urllib.request.Request(
        f"{base}/echo", data=json.dumps({"x": 1}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        out = json.loads(r.read())
    assert out == {"result": {"echo": {"x": 1}}}

    with urllib.request.urlopen(f"{base}/-/healthz", timeout=10) as r:
        assert r.read() == b"ok"


@pytest.mark.slow
def test_jitted_model_deployment(serve_cluster):
    """Deploy a GPT forward and sustain concurrent
    requests (the port's forward on the CPU in place of the jitted one)."""
    @serve.deployment(num_replicas=1, max_concurrent_queries=8,
                      ray_actor_options={"num_cpus": 1})
    class GPTServer:
        def __init__(self):
            import dataclasses

            import torch
            from ray_tpu_torch.models.gpt import (GPTConfig, gpt_forward,
                                                  gpt_init)
            # Dense attention: "auto" would consult the autotune cache.
            self.cfg = dataclasses.replace(GPTConfig.tiny(),
                                           attention="dense")
            self.params = gpt_init(0, self.cfg, device="cpu")
            self.fwd = gpt_forward
            self.torch = torch
            # One warm-up forward so requests measure steady state.
            self.fwd(self.params, torch.ones((1, 16), dtype=torch.long),
                     self.cfg)

        def __call__(self, token_list):
            with self.torch.no_grad():
                toks = self.torch.tensor([token_list], dtype=self.torch.long)
                logits = self.fwd(self.params, toks, self.cfg)
            return [float(x) for x in logits[0, -1, :4]]

    h = serve.run(GPTServer.bind())
    tokens = list(range(16))
    refs = [h.remote(tokens) for _ in range(12)]
    outs = ray_tpu_torch.get(refs, timeout=300)
    assert all(len(o) == 4 for o in outs)
    # Deterministic forward: every request sees identical logits.
    assert all(o == outs[0] for o in outs)
    serve.delete("GPTServer")


@pytest.mark.slow
def test_autoscaling_up(serve_cluster):
    import threading

    @serve.deployment(num_replicas=1, max_concurrent_queries=4,
                      ray_actor_options={"num_cpus": 0.1},
                      autoscaling_config={"min_replicas": 1,
                                          "max_replicas": 3,
                                          "target_queue_len": 1.0})
    class Slow:
        def __call__(self, x):
            time.sleep(0.3)
            return x

    h = serve.run(Slow.bind())
    stop = threading.Event()

    def flood():
        while not stop.is_set():
            try:
                ray_tpu_torch.get([h.remote(i) for i in range(8)], timeout=60)
            except Exception:
                return

    t = threading.Thread(target=flood, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 90
        while serve.status()["Slow"]["running"] < 2:
            assert time.monotonic() < deadline, "never scaled up"
            time.sleep(0.5)
    finally:
        stop.set()
        t.join(timeout=30)


def test_deployment_graph_composition(serve_cluster):
    """A deployment bound with another deployment receives its handle
    (reference: serve deployment graphs): Model calls Preprocessor
    through the router."""
    from ray_tpu_torch import serve

    @serve.deployment(name="graph_pre")
    class Preprocessor:
        def __call__(self, x):
            return x * 2

    @serve.deployment(name="graph_model")
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            import ray_tpu_torch
            return ray_tpu_torch.get(self.pre.remote(x)) + 1

    handle = serve.run(Model.bind(Preprocessor.bind()))
    assert ray_tpu_torch.get(handle.remote(10), timeout=120) == 21
    serve.delete("graph_model")
    serve.delete("graph_pre")


def test_long_poll_push_beats_ttl(serve_cluster):
    """Scale-up must reach an existing handle WITHOUT its TTL refresh
    (reference serve/_private/long_poll.py).  The TTL
    is 30s; the long-poll listener must deliver the new replica set in a
    couple of reconcile periods."""
    from ray_tpu_torch.serve import router as router_mod

    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.1})
    class LP:
        def __call__(self, x):
            return x

    h = serve.run(LP.bind())
    assert ray_tpu_torch.get(h.remote(1), timeout=60) == 1   # starts the listener
    with h._lock:
        n0 = len(h._replicas)
    assert n0 == 1

    serve.run(LP.options(num_replicas=3).bind())
    deadline = time.monotonic() + 15              # << REFRESH_PERIOD_S=30
    n = n0
    while time.monotonic() < deadline:
        with h._lock:
            n = len(h._replicas)
        if n == 3:
            break
        time.sleep(0.2)
    assert n == 3, f"push update never arrived (replicas={n})"
    # Only the long-poll listener advances _version (TTL _refresh doesn't),
    # so a bumped version proves the push path delivered the update.
    assert h._version >= 1
    assert router_mod.REFRESH_PERIOD_S >= 30.0


def test_declarative_schema_deploy(serve_cluster, tmp_path):
    """serve deploy path: YAML config -> import_path resolution ->
    options override -> running deployment (reference: serve deploy +
    ServeApplicationSchema)."""
    from ray_tpu_torch.serve.schema import (ServeApplicationSchema,
                                      deploy_application)
    mod = tmp_path / "my_app.py"
    mod.write_text(
        "from ray_tpu_torch import serve\n"
        "@serve.deployment(ray_actor_options={'num_cpus': 0.1})\n"
        "class Echo:\n"
        "    def __init__(self, prefix='x'):\n"
        "        self.prefix = prefix\n"
        "    def __call__(self, s):\n"
        "        return self.prefix + str(s)\n")
    import sys
    sys.path.insert(0, str(tmp_path))
    try:
        cfg = {
            "deployments": [{
                "name": "EchoSvc",
                "import_path": "my_app:Echo",
                "num_replicas": 2,
                "init_kwargs": {"prefix": "hi:"},
            }],
        }
        schema = ServeApplicationSchema.from_dict(cfg)
        st = deploy_application(schema)
        assert st["EchoSvc"]["running"] == 2
        h = serve.get_handle("EchoSvc")
        assert ray_tpu_torch.get(h.remote(7)) == "hi:7"
        serve.delete("EchoSvc")
    finally:
        sys.path.remove(str(tmp_path))


def test_schema_validation_errors(tmp_path):
    from ray_tpu_torch.serve.schema import ServeApplicationSchema
    with pytest.raises(ValueError, match="no deployments"):
        ServeApplicationSchema.from_dict({})
    with pytest.raises(ValueError, match="unknown deployment config"):
        ServeApplicationSchema.from_dict(
            {"deployments": [{"name": "a", "import_path": "m:a",
                              "replicas": 3}]})
    with pytest.raises(ValueError, match="duplicate deployment names"):
        ServeApplicationSchema.from_dict(
            {"deployments": [{"name": "a", "import_path": "m:a"},
                             {"name": "a", "import_path": "m:b"}]})
    # YAML round-trip
    p = tmp_path / "app.yaml"
    p.write_text("deployments:\n  - name: a\n    import_path: m:a\n"
                 "    num_replicas: 3\n")
    s = ServeApplicationSchema.from_file(str(p))
    assert s.deployments[0].num_replicas == 3


def test_user_config_reconfigure_without_restart(serve_cluster):
    """user_config changes push reconfigure() into LIVE replicas (no
    restart); reference: deployment user_config + replica reconfigure."""
    import os

    @serve.deployment(num_replicas=1, user_config={"factor": 2},
                      ray_actor_options={"num_cpus": 0.1})
    class Scaler:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return self.factor * x, os.getpid()

    h = serve.run(Scaler.bind())
    v, pid1 = ray_tpu_torch.get(h.remote(10))
    assert v == 20                       # init-time user_config applied

    h = serve.run(Scaler.options(user_config={"factor": 7}).bind())
    deadline = time.time() + 20
    while time.time() < deadline:
        v, pid2 = ray_tpu_torch.get(h.remote(10))
        if v == 70:
            break
        time.sleep(0.3)
    assert v == 70
    assert pid2 == pid1, "replica restarted on a config-only change"
    serve.delete("Scaler")


def test_scale_down_drains_in_flight_requests(serve_cluster):
    """Replica removal drains in-flight requests before the kill
    (reference: graceful replica shutdown); routers are version-bumped
    off the victim first so the drain can finish."""
    @serve.deployment(num_replicas=2, max_concurrent_queries=4,
                      ray_actor_options={"num_cpus": 0.1})
    class Slow:
        def __call__(self, x):
            time.sleep(1.5)
            return x * 2

    h = serve.run(Slow.bind())
    inflight = [h.remote(i) for i in range(6)]
    time.sleep(0.3)                      # requests land on both replicas
    h2 = serve.run(Slow.options(num_replicas=1).bind())  # scale down
    # Every in-flight request must complete despite the kill.
    assert sorted(ray_tpu_torch.get(inflight, timeout=60)) == \
        [0, 2, 4, 6, 8, 10]
    assert ray_tpu_torch.get(h2.remote(21), timeout=30) == 42
    serve.delete("Slow")


def test_controller_crash_recovery(serve_cluster):
    """The controller dies and restarts (max_restarts=-1): it restores
    deployments + re-adopts LIVE replicas from its KV snapshot — serving
    continues without replica restarts (reference: controller
    checkpoint/recover)."""
    import os as _os

    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __call__(self, x):
            return (x, _os.getpid())

    h = serve.run(Echo.bind())
    _, pid_before = ray_tpu_torch.get(h.remote(1))
    # Wait until a reconcile has actually persisted the KV snapshot with
    # both replicas — the persist runs on the 0.5s reconcile loop, and a
    # wall-clock sleep races it on a loaded box.
    from ray_tpu_torch._private import cloudpickle
    from ray_tpu_torch._private.kv import kv_get
    deadline = time.monotonic() + 30
    while True:
        raw = kv_get(b"state", ns="serve")
        if raw:
            snap = cloudpickle.loads(raw)
            if len(snap.get("deployments", {})
                    .get("Echo", (None, 0, []))[2]) == 2:
                break
        assert time.monotonic() < deadline, \
            "controller never persisted its state snapshot"
        time.sleep(0.2)

    ctrl = ray_tpu_torch.get_actor("_serve_controller")
    ray_tpu_torch.kill(ctrl, no_restart=False)

    # A fresh handle reaches the RESTARTED controller; requests still
    # serve and land on the pre-crash replica processes.
    deadline = time.monotonic() + 60
    pids = set()
    while time.monotonic() < deadline:
        try:
            h2 = serve.get_handle("Echo")
            for i in range(4):
                _, pid = ray_tpu_torch.get(h2.remote(i), timeout=20)
                pids.add(pid)
            break
        except Exception:
            time.sleep(0.5)
    assert pids, "no requests served after controller restart"
    assert pid_before in pids, "replicas were restarted, not re-adopted"
    st = serve.status()
    assert st["Echo"]["target"] == 2
    serve.delete("Echo")


# ------------------------------------------------------------ card cases
#
# The fixture's node has two fake cards.  A num_gpus=1 replica holds one
# whole card, named in its CUDA_VISIBLE_DEVICES by the raylet.


def _card_app(name, num_replicas=1):
    @serve.deployment(name=name, num_replicas=num_replicas,
                      ray_actor_options={"num_cpus": 0.1, "num_gpus": 1})
    class Card:
        def __call__(self, _=None):
            return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    return Card.bind()


def _wait_free_cards(n, timeout=60):
    deadline = time.monotonic() + timeout
    while True:
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if free == n:
            return
        assert time.monotonic() < deadline, f"{free} cards free, not {n}"
        time.sleep(0.2)


def _replica_cards(handle, n, timeout=120):
    """{pid: CUDA_VISIBLE_DEVICES} of the n replicas behind ``handle``."""
    seen = {}
    deadline = time.monotonic() + timeout
    while len(seen) < n:
        assert time.monotonic() < deadline, seen
        for card, pid in ray_tpu_torch.get(
                [handle.remote() for _ in range(8)], timeout=timeout):
            seen[pid] = card
    return seen


@pytest.fixture
def no_card_leak(serve_cluster):
    _wait_free_cards(2)
    yield
    _wait_free_cards(2)


def test_gpu_replica_sees_only_its_leased_card(no_card_leak):
    h = serve.run(_card_app("cards", num_replicas=2))
    cards = _replica_cards(h, 2)
    assert sorted(cards.values()) == ["0", "1"], cards
    _wait_free_cards(0)
    serve.delete("cards")


def test_gpu_cards_return_on_scale_down_and_delete(no_card_leak):
    h = serve.run(_card_app("cards2", num_replicas=2))
    before = _replica_cards(h, 2)
    serve.run(_card_app("cards2", num_replicas=1))
    _wait_free_cards(1)
    # The card the scale-down freed goes to the next num_gpus=1 replica.
    (kept,) = _replica_cards(serve.get_handle("cards2"), 1).values()
    (freed,) = set(before.values()) - {kept}
    h2 = serve.run(_card_app("cards3"))
    assert list(_replica_cards(h2, 1).values()) == [freed]
    serve.delete("cards2")
    _wait_free_cards(1)
    serve.delete("cards3")


def test_gpu_deployment_waits_for_a_card(no_card_leak):
    """With no card free, a num_gpus=1 replica stays pending: it never
    runs on the CPU, and it starts on the card its predecessor frees."""
    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def card(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    holder = Holder.remote()          # leaves one card, as on a 1-card node
    held = ray_tpu_torch.get(holder.card.remote(), timeout=120)
    first = serve.run(_card_app("first"))
    (card,) = _replica_cards(first, 1).values()
    assert card != held
    serve.run(_card_app("second"))
    pending = serve.get_handle("second").remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3)
    assert ready == [], "a num_gpus=1 replica ran without a card"
    serve.delete("first")
    got, _ = ray_tpu_torch.get(pending, timeout=120)
    assert got == card
    serve.delete("second")
    ray_tpu_torch.kill(holder)


def test_gpu_rolling_restart_frees_the_victims_card(no_card_leak):
    """The rollout surges first (reference controller.py rolling_restart):
    the replacement takes the second card, then the victim drains and its
    card returns; no lease leaks."""
    h = serve.run(_card_app("roll"))
    (old,) = _replica_cards(h, 1).values()
    res = serve.rolling_restart("roll")
    assert res["replaced"] == 1 and res["skipped"] == 0, res
    (new,) = _replica_cards(serve.get_handle("roll"), 1).values()
    assert new != old
    _wait_free_cards(1)
    serve.delete("roll")
