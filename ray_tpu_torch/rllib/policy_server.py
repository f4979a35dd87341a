"""Client-server RL: serve a policy to external simulator processes.

Port of ``ray_tpu/rllib/policy_server.py`` (the protocol copied).  Design
analog: reference ``rllib/env/policy_server_input.py:1``
(``PolicyServerInput``: an input reader that runs an HTTP server; external
``PolicyClient`` processes (``rllib/env/policy_client.py:1``) drive
episodes in simulators RLlib does not control, actions are computed
server-side, and the logged experiences become the algorithm's train
batches) and ``rllib/env/external_env.py:1`` (the episode-command
protocol: start_episode / get_action / log_returns / end_episode).

Here the transport is newline-delimited JSON over TCP (the framework's
in-tree ingress style — no HTTP dependency), the server is a background
thread inside the algorithm process, and inference is server-side on the
learner's policy, so clients always act on the freshest weights without
ever holding them.  The server's threads read ``policy.params`` while the
learner updates: a torch optimizer could step in place, so the policies
here never change their params in place; an update builds new tensors
and publishes them by assigning ``policy.params`` when it is done, and a
request acts on one whole set of weights, old or new.

Usage (server / learner process)::

    algo = (PPOConfig().environment("CartPole-v1")   # spaces only
            .rollouts(input="policy_server",
                      policy_server_port=9900)
            .build())
    while True: algo.train()

Usage (external simulator process)::

    client = PolicyClient("127.0.0.1:9900")
    eid = client.start_episode()
    a = client.get_action(eid, obs)
    client.log_returns(eid, reward)
    client.end_episode(eid, obs)
"""

from __future__ import annotations

import json
import socket
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP, ADVANTAGES,
                                        DONES, OBS, REWARDS, SampleBatch,
                                        VALUE_TARGETS, VF_PREDS)


class _Episode:
    __slots__ = ("obs", "actions", "logps", "vfs", "rewards", "final_obs")

    def __init__(self):
        self.obs: List = []
        self.actions: List = []
        self.logps: List = []
        self.vfs: List = []
        self.rewards: List = []


class PolicyServerInput:
    """TCP policy server + experience collector; ``sample()`` is the
    algorithm-facing side (drop-in for the rollout-sampling path)."""

    def __init__(self, policy, config: Dict[str, Any]):
        # The server drives the policy's PURE actor (params, generator,
        # obs) -> (actions, logp, values) with a generator it owns:
        # calling the stateful compute_actions here would race the
        # learner thread's own rng split.  Only actor-critic on-policy
        # policies expose this surface — fail at build, not per request.
        if not hasattr(policy, "_act") or \
                not hasattr(policy, "compute_values") or \
                hasattr(policy, "_ensure_state"):
            # recurrent policies carry rollout state whose _act signature
            # differs — reject them here too, not per request
            raise ValueError(
                "input='policy_server' needs a non-recurrent actor-critic "
                f"on-policy policy (PPO-family); got "
                f"{type(policy).__name__}")
        self._policy = policy
        import torch
        self._torch = torch
        self._gen = torch.Generator(device=policy.device).manual_seed(
            config.get("seed", 0) + 31337)
        self._gamma = config.get("gamma", 0.99)
        self._lambda = config.get("lambda", 0.95)
        # One train batch per fragment of completed external steps.
        # (num_envs_per_worker is meaningless here: external clients, not
        # per-worker envs, produce the experience.)
        self._min_steps = config.get("rollout_fragment_length", 128)
        self._lock = threading.Lock()
        # Inference serializes on its own lock (the generator is shared)
        # so a slow compute_actions never blocks end_episode/sample
        # bookkeeping on the main lock.
        self._infer_lock = threading.Lock()
        self._episodes: Dict[str, _Episode] = {}
        self._completed: List[Tuple[_Episode, bool]] = []  # (ep, terminated)
        self._completed_steps = 0
        self._have_steps = threading.Condition(self._lock)
        self.episode_rewards: List[float] = []
        self.episode_lens: List[int] = []
        host = config.get("policy_server_host", "127.0.0.1")
        port = config.get("policy_server_port", 0)
        self._srv = socket.create_server((host, port))
        self.address = "%s:%d" % self._srv.getsockname()[:2]
        self._shutdown = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rt-policy-server")
        self._thread.start()

    # -- server side ------------------------------------------------------

    def _serve(self) -> None:
        self._srv.settimeout(0.5)
        while not self._shutdown:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        try:
            for line in f:
                try:
                    reply = self._handle(json.loads(line))
                except Exception as e:  # protocol error -> client sees it
                    reply = {"error": repr(e)}
                f.write((json.dumps(reply) + "\n").encode())
                f.flush()
        except (ConnectionResetError, BrokenPipeError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "start_episode":
            eid = uuid.uuid4().hex[:16]
            with self._lock:
                self._episodes[eid] = _Episode()
            return {"episode_id": eid}
        eid = msg.get("episode_id")
        if cmd == "get_action":
            obs = np.asarray(msg["obs"], np.float32)[None]
            policy = self._policy
            with self._infer_lock:
                # One read of policy.params: a whole published set.
                actions, logp, v = policy._act(
                    policy.params, self._gen,
                    self._torch.as_tensor(obs, device=policy.device))
                actions, logp, v = (actions.cpu().numpy(),
                                    logp.cpu().numpy(), v.cpu().numpy())
            act = actions[0]
            with self._lock:
                ep = self._episodes[eid]
                ep.obs.append(obs[0])
                ep.actions.append(act)
                ep.logps.append(float(logp[0]))
                ep.vfs.append(float(v[0]))
                ep.rewards.append(0.0)   # filled by log_returns
            return {"action": act.tolist() if hasattr(act, "tolist")
                    else act}
        if cmd == "log_returns":
            with self._lock:
                ep = self._episodes[eid]
                if not ep.rewards:
                    raise ValueError("log_returns before get_action")
                ep.rewards[-1] += float(msg["reward"])
            return {"ok": True}
        if cmd == "end_episode":
            with self._have_steps:
                ep = self._episodes.pop(eid)
                if ep.obs:
                    terminated = not msg.get("truncated", False)
                    if not terminated:
                        if msg.get("obs") is None:
                            raise ValueError(
                                "truncated end_episode requires the final "
                                "obs (the learner bootstraps its value)")
                        # bootstrap value from the final observation
                        ep.final_obs = np.asarray(
                            msg["obs"], np.float32)
                    self._completed.append((ep, terminated))
                    self._completed_steps += len(ep.obs)
                    self.episode_rewards.append(float(sum(ep.rewards)))
                    self.episode_lens.append(len(ep.obs))
                    self._have_steps.notify_all()
            return {"ok": True}
        raise ValueError(f"unknown cmd {cmd!r}")

    # -- algorithm side ---------------------------------------------------

    def sample(self, timeout: float = 300.0) -> SampleBatch:
        """Block until enough completed-episode steps arrived, then build
        one train batch (per-episode GAE, terminated episodes bootstrap
        0, truncated ones bootstrap the policy's value at the final
        obs)."""
        from ray_tpu_torch.rllib.policy import compute_gae
        with self._have_steps:
            ok = self._have_steps.wait_for(
                lambda: self._completed_steps >= self._min_steps,
                timeout=timeout)
            if not ok and not self._completed:
                raise TimeoutError(
                    f"policy server collected no episodes in {timeout}s "
                    f"(no client connected to {self.address}?)")
            eps, self._completed = self._completed, []
            self._completed_steps = 0
        parts: List[SampleBatch] = []
        for ep, terminated in eps:
            T = len(ep.obs)
            rew = np.asarray(ep.rewards, np.float32)[:, None]
            vfs = np.asarray(ep.vfs, np.float32)[:, None]
            dones = np.zeros((T, 1), bool)
            dones[-1, 0] = terminated
            if terminated:
                boot = np.zeros((1,), np.float32)
            else:
                boot = self._policy.compute_values(
                    np.asarray(getattr(ep, "final_obs"))[None])
            adv, targets = compute_gae(rew, vfs, dones, boot,
                                       self._gamma, self._lambda)
            parts.append(SampleBatch({
                OBS: np.asarray(ep.obs, np.float32),
                ACTIONS: np.asarray(ep.actions),
                ACTION_LOGP: np.asarray(ep.logps, np.float32),
                VF_PREDS: vfs[:, 0],
                REWARDS: rew[:, 0],
                DONES: dones[:, 0],
                ADVANTAGES: adv[:, 0],
                VALUE_TARGETS: targets[:, 0],
            }))
        return SampleBatch.concat_samples(parts)

    def get_metrics(self) -> Dict[str, Any]:
        with self._lock:
            r, self.episode_rewards = self.episode_rewards, []
            ln, self.episode_lens = self.episode_lens, []
        return {"episode_rewards": r, "episode_lens": ln}

    def stop(self) -> None:
        self._shutdown = True
        try:
            self._srv.close()
        except OSError:
            pass


class PolicyClient:
    """External-process client (reference: rllib/env/policy_client.py:1).

    Thread-safe for sequential use; one TCP connection, newline JSON."""

    def __init__(self, address: str, timeout: float = 60.0):
        host, _, port = address.rpartition(":")
        self._sock = socket.create_connection((host or "127.0.0.1",
                                               int(port)), timeout=timeout)
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def _call(self, msg: dict) -> dict:
        with self._lock:
            self._f.write((json.dumps(msg) + "\n").encode())
            self._f.flush()
            line = self._f.readline()
        if not line:
            raise ConnectionError("policy server closed the connection")
        reply = json.loads(line)
        if "error" in reply:
            raise RuntimeError(f"policy server error: {reply['error']}")
        return reply

    def start_episode(self) -> str:
        return self._call({"cmd": "start_episode"})["episode_id"]

    def get_action(self, episode_id: str, obs) -> Any:
        obs = np.asarray(obs, np.float32)
        return self._call({"cmd": "get_action", "episode_id": episode_id,
                           "obs": obs.tolist()})["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call({"cmd": "log_returns", "episode_id": episode_id,
                    "reward": float(reward)})

    def end_episode(self, episode_id: str, obs=None,
                    truncated: bool = False) -> None:
        msg = {"cmd": "end_episode", "episode_id": episode_id,
               "truncated": bool(truncated)}
        if obs is not None:
            msg["obs"] = np.asarray(obs, np.float32).tolist()
        self._call(msg)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
