"""Offline RL: dataset IO, behavior cloning, CQL, off-policy estimation.

Port of ``ray_tpu/rllib/offline.py``: the dataset IO, the estimator and
the MC returns are copied (numpy; the npz shards read and write in both
packages), the BC, MARWIL and CQL updates are torch.  Design analog:
reference ``rllib/offline/`` — ``json_writer.py`` / ``json_reader.py``
(experience output/input), ``dataset_writer.py``,
``estimators/importance_sampling.py``, and the BC/CQL algorithms under
``rllib/algorithms/bc|cql``.  Shards are ``.npz`` (columnar numpy,
mmap-able, no per-row JSON parse — batches move to the device whole).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (DiagGaussian, OptaxAdam,
                                        TorchPolicy, ac_forward, ac_init,
                                        head_forward, stats_to_floats,
                                        tree_leaves, tree_unflatten,
                                        value_and_grad)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP, DONES,
                                        NEXT_OBS, OBS, REWARDS, SampleBatch)


# ------------------------------------------------------------ dataset IO

class DatasetWriter:
    """Writes SampleBatches as numbered .npz shards under a directory.

    Reference analog: ``rllib/offline/json_writer.py`` (OutputWriter
    contract) — columnar npz instead of row JSON so the read side feeds
    the device without parsing.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._seq = 0
        self._meta = {"created_at": time.time(), "shards": 0, "rows": 0}

    def write(self, batch: SampleBatch) -> str:
        shard = os.path.join(self.path,
                             f"shard-{os.getpid()}-{self._seq:05d}.npz")
        self._seq += 1
        # Write via an open handle so np.savez can't append '.npz' to the
        # temp name — a temp ending in .npz would match the reader's shard
        # filter and a crash mid-write would poison the dataset.
        tmp = shard + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in batch.items()})
        os.replace(tmp, shard)
        self._meta["shards"] += 1
        self._meta["rows"] += batch.count
        with open(os.path.join(self.path, f"meta-{os.getpid()}.json"),
                  "w") as f:
            json.dump(self._meta, f)
        return shard


class DatasetReader:
    """Reads a DatasetWriter directory back as SampleBatches.

    ``iter_batches`` cycles shards forever (training); ``read_all``
    concatenates everything (small datasets / evaluation).  Reference
    analog: ``rllib/offline/json_reader.py`` (InputReader.next).
    """

    def __init__(self, path: str, shuffle: bool = True, seed: int = 0):
        self.path = path
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._shards = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".npz"))
        if not self._shards:
            raise FileNotFoundError(f"no .npz shards under {path!r}")

    def _load(self, shard: str) -> SampleBatch:
        with np.load(shard) as z:
            return SampleBatch({k: z[k] for k in z.files})

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(
            [self._load(s) for s in self._shards])

    def iter_batches(self, batch_size: int,
                     data: Optional[SampleBatch] = None
                     ) -> Iterator[SampleBatch]:
        """Infinite minibatch stream over the whole dataset.  ``data``
        overrides the source batch (MARWIL passes the dataset with its
        precomputed returns column attached)."""
        if data is None:
            data = self.read_all()
        n = data.count
        # A dataset smaller than one batch still yields (the whole thing,
        # shuffled) — range() would otherwise be empty and the generator
        # would spin forever without yielding.
        batch_size = min(batch_size, n)
        while True:
            idx = (self._rng.permutation(n) if self.shuffle
                   else np.arange(n))
            for lo in range(0, n - batch_size + 1, batch_size):
                take = idx[lo:lo + batch_size]
                yield SampleBatch({k: v[take] for k, v in data.items()})


# ----------------------------------------------- off-policy estimation

class ImportanceSamplingEstimator:
    """Ordinary + weighted per-episode IS estimates of a target policy's
    value from behavior data (reference:
    ``rllib/offline/estimators/importance_sampling.py``).

    Needs ``action_logp`` of the BEHAVIOR policy in the batch and a
    target policy exposing ``logp_for(obs, actions)``.
    """

    def __init__(self, gamma: float = 0.99):
        self.gamma = gamma

    def estimate(self, batch: SampleBatch, target_policy) -> Dict[str, float]:
        logp_new = np.asarray(
            target_policy.logp_for(batch[OBS], batch[ACTIONS]))
        ratios = np.exp(logp_new - np.asarray(batch[ACTION_LOGP]))
        dones = np.asarray(batch[DONES]).astype(bool)
        rewards = np.asarray(batch[REWARDS])
        v_is, v_wis_num, v_wis_den = [], [], []
        start = 0
        for end in list(np.nonzero(dones)[0] + 1) or [len(rewards)]:
            w = float(np.prod(np.clip(ratios[start:end], 1e-4, 1e4)))
            disc = self.gamma ** np.arange(end - start)
            ret = float(np.sum(rewards[start:end] * disc))
            v_is.append(w * ret)
            v_wis_num.append(w * ret)
            v_wis_den.append(w)
            start = end
        return {
            "v_is": float(np.mean(v_is)) if v_is else 0.0,
            "v_wis": (float(np.sum(v_wis_num) / max(np.sum(v_wis_den),
                                                    1e-8))
                      if v_wis_den else 0.0),
            "num_episodes": len(v_is),
        }


# ------------------------------------------------------------------- BC

class BCPolicy(TorchPolicy):
    """Behavior cloning: maximize logp of dataset actions.

    Shares the MLP actor network with PPO (``ac_init``/``ac_forward``);
    the value head is unused.  Rollout workers use it for evaluation
    only.  Reference analog: ``rllib/algorithms/bc/bc.py`` (MARWIL with
    beta=0).
    """

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        self._setup(action_space, config, seed)
        self.params = ac_init(self._init_gen, obs_dim, self.num_outputs,
                              tuple(config.get("hiddens", (64, 64))),
                              device=self.device)
        self._opt = OptaxAdam(tree_leaves(self.params),
                              config.get("lr", 1e-3))

    @torch.no_grad()
    def _act(self, params, gen, obs):
        pi, _ = ac_forward(params, obs)
        # Greedy eval: BC imitates; sampling noise only hurts.
        if self.discrete:
            actions = torch.argmax(pi, dim=-1).to(torch.int32)
        else:
            actions = DiagGaussian.split(pi)[0]
        return actions, self.dist.logp(pi, actions)

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        actions, logp = self._act(self.params, self._act_gen,
                                  self._obs(obs))
        return {ACTIONS: actions.cpu().numpy(),
                ACTION_LOGP: logp.cpu().numpy(),
                "vf_preds": np.zeros((obs.shape[0],), np.float32)}

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        # No value head in BC; evaluation sampling only needs a shape.
        return np.zeros((obs.shape[0],), np.float32)

    @torch.no_grad()
    def logp_for(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        pi, _ = ac_forward(self.params, self._obs(obs))
        acts = torch.as_tensor(np.asarray(actions), device=self.device)
        return self.dist.logp(pi, acts).cpu().numpy()

    def _step(self, loss_fn) -> Dict[str, torch.Tensor]:
        stats, grads = value_and_grad(loss_fn, self.params)
        self.params = tree_unflatten(self.params, self._opt.step(
            tree_leaves(self.params), grads))
        return stats

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        obs = self._obs(batch[OBS])
        actions = torch.as_tensor(np.asarray(batch[ACTIONS]),
                                  device=self.device)

        def loss(p):
            pi, _ = ac_forward(p, obs)
            bc = -torch.mean(self.dist.logp(pi, actions))
            return bc, {"bc_loss": bc}
        return stats_to_floats(self._step(loss))


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BC)
        self._config.update({
            "policy": "bc",
            "input": None,              # dataset dir (DatasetWriter layout)
            "train_batch_size": 512,
            "sgd_iters_per_step": 16,
            "lr": 1e-3,
            "hiddens": (64, 64),
            "num_rollout_workers": 0,   # env used for evaluation only
        })

    def offline_data(self, *, input: str) -> "BCConfig":  # noqa: A002
        self._config["input"] = input
        return self


class BC(Algorithm):
    """Train from a logged dataset; evaluate by rolling the env."""

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        if not config.get("input"):
            raise ValueError("BC requires config['input'] (dataset dir)")
        self._reader = DatasetReader(config["input"],
                                     seed=config.get("seed", 0))
        self._batches = self._reader.iter_batches(
            config.get("train_batch_size", 512))

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        for _ in range(self.config.get("sgd_iters_per_step", 16)):
            batch = next(self._batches)
            stats = policy.learn_on_batch(batch)
            self._timesteps_total += batch.count
        self.workers.sync_weights()
        # Evaluation rollout: fills episode metrics with the cloned
        # policy's actual env performance.
        self.workers.synchronous_sample()
        return {"info": {"learner": stats},
                **{f"learner_{k}": v for k, v in stats.items()}}


# ------------------------------------------------------------------ CQL

class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(CQL)
        self._config.update({
            "policy": "dqn",            # Q-network policy for evaluation
            "input": None,
            "train_batch_size": 512,
            "sgd_iters_per_step": 16,
            "cql_alpha": 1.0,
            "lr": 5e-4,
            "gamma": 0.99,
            # Evaluation rollouts should reflect the learned Q greedily.
            "epsilon_initial": 0.02,
            "epsilon_final": 0.02,
            "target_update_freq": 8,    # in training_steps
            "hiddens": (64, 64),
            "num_rollout_workers": 0,
        })

    def offline_data(self, *, input: str) -> "CQLConfig":  # noqa: A002
        self._config["input"] = input
        return self


class CQL(Algorithm):
    """Discrete-action conservative Q-learning over a logged dataset.

    Loss = TD error + alpha * (logsumexp_a Q(s, a) - Q(s, a_data)):
    push down out-of-distribution action values, push up the data's
    (reference: ``rllib/algorithms/cql/cql.py``; discrete form per the
    CQL(H) objective).  Reuses the DQN policy's network so the result
    evaluates/acts exactly like a trained DQN.
    """

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        if not config.get("input"):
            raise ValueError("CQL requires config['input'] (dataset dir)")
        self._reader = DatasetReader(config["input"],
                                     seed=config.get("seed", 0))
        self._batches = self._reader.iter_batches(
            config.get("train_batch_size", 512))
        self._build_update()

    def _build_update(self):
        policy = self.workers.local_worker.policy
        self._alpha = self.config.get("cql_alpha", 1.0)
        self._gamma = self.config.get("gamma", 0.99)
        self._opt = OptaxAdam(tree_leaves(policy.params),
                              self.config.get("lr", 5e-4))
        # Params are replaced, never changed in place: the target holds
        # the tensors of its time.
        self._target = policy.params

    def _cql_loss(self, params, b):
        q = head_forward(params, b[OBS])
        q_data = torch.gather(q, -1, b[ACTIONS][:, None].long())[:, 0]
        with torch.no_grad():
            q_next = head_forward(self._target, b[NEXT_OBS])
            td_target = b[REWARDS] + self._gamma * (1.0 - b[DONES]) * \
                torch.max(q_next, dim=-1).values
        td = torch.mean((q_data - td_target) ** 2)
        conservative = torch.mean(torch.logsumexp(q, dim=-1) - q_data)
        total = td + self._alpha * conservative
        return total, {"cql_loss": total, "td_loss": td,
                       "conservative_gap": conservative}

    def _cql_step(self, b: SampleBatch) -> Dict[str, float]:
        """One update of the local policy's Q-network on batch ``b``."""
        policy = self.workers.local_worker.policy
        dev = policy.device
        tensors = {k: torch.as_tensor(
            np.asarray(b[k], None if k == ACTIONS else np.float32),
            device=dev) for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES)}
        stats, grads = value_and_grad(
            lambda p: self._cql_loss(p, tensors), policy.params)
        policy.params = tree_unflatten(policy.params, self._opt.step(
            tree_leaves(policy.params), grads))
        return stats_to_floats(stats)

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        for _ in range(self.config.get("sgd_iters_per_step", 16)):
            b = next(self._batches)
            stats = self._cql_step(b)
            self._timesteps_total += b.count
        if self.iteration % self.config.get("target_update_freq", 8) == 0:
            self._target = policy.params
        self.workers.sync_weights()
        self.workers.synchronous_sample()   # evaluation metrics
        return {"info": {"learner": stats},
                **{f"learner_{k}": v for k, v in stats.items()}}


# --------------------------------------------------------------- MARWIL

def compute_mc_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-episode Monte-Carlo discounted returns over row-ordered data
    (episodes cut at dones; a truncated final segment is treated as an
    episode).  Reference analog: postprocessing.compute_advantages with
    use_gae=False, use_critic=False."""
    returns = np.zeros_like(rewards, dtype=np.float64)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        returns[t] = acc
    return returns.astype(np.float32)


class MARWILPolicy(BCPolicy):
    """Monotonic advantage re-weighted imitation learning.

    BC weighted by exp(beta * advantage): the value head estimates V(s),
    advantage = MC-return - V, and the exp weight focuses cloning on
    better-than-average trajectories.  beta=0 degrades exactly to BC
    (reference: ``rllib/algorithms/marwil/marwil.py`` — its BC subclass
    is literally beta=0).  The advantage-norm moving average that keeps
    exp() in range is carried as policy state, like the reference's
    ``update_averaged_estimate``.
    """

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        super().__init__(obs_dim, action_space, config, seed=seed)
        self._beta = config.get("beta", 1.0)
        self._vf_coeff = config.get("vf_coeff", 1.0)
        self._ma_rate = config.get(
            "moving_average_sqd_adv_norm_update_rate", 1e-2)
        self._ma_adv_sq = torch.tensor(
            config.get("moving_average_sqd_adv_norm_start", 100.0),
            dtype=torch.float32, device=self.device)

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        if "returns" not in batch:
            raise ValueError("MARWIL batches need a 'returns' column "
                             "(MARWIL.setup precomputes it)")
        obs = self._obs(batch[OBS])
        actions = torch.as_tensor(np.asarray(batch[ACTIONS]),
                                  device=self.device)
        returns = self._obs(batch["returns"])
        ma = self._ma_adv_sq
        adv_out = []

        def loss(p):
            pi, v = ac_forward(p, obs)
            adv = returns - v
            adv_sg = adv.detach()
            adv_out.append(adv_sg)
            # exp-weight with the advantage normalized by the moving
            # RMS; clip for numerical safety like the reference.
            w = torch.exp(torch.clamp(
                self._beta * adv_sg / torch.sqrt(ma + 1e-8), -3.0, 3.0))
            pg = -torch.mean(w * self.dist.logp(pi, actions))
            vf = torch.mean(adv ** 2)
            total = pg + self._vf_coeff * vf
            return total, {"marwil_loss": total, "policy_loss": pg,
                           "vf_loss": vf}

        stats = self._step(loss)
        self._ma_adv_sq = ma + self._ma_rate * (
            torch.mean(adv_out[0] ** 2) - ma)
        return stats_to_floats(stats)


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MARWIL)
        self._config.update({
            "policy": "marwil",
            "input": None,
            "beta": 1.0,
            "vf_coeff": 1.0,
            "gamma": 0.99,
            "train_batch_size": 512,
            "sgd_iters_per_step": 16,
            "lr": 1e-3,
            "hiddens": (64, 64),
            "num_rollout_workers": 0,
        })

    def offline_data(self, *, input: str) -> "MARWILConfig":  # noqa: A002
        self._config["input"] = input
        return self


class MARWIL(Algorithm):
    """Offline advantage-weighted cloning from a logged dataset.

    MC returns are computed ONCE over the row-ordered dataset (before any
    shuffling — episode structure is positional) and carried as an extra
    column through the minibatch stream.
    """

    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "marwil")
        super().setup(config)
        if not config.get("input"):
            raise ValueError("MARWIL requires config['input'] "
                             "(dataset dir)")
        reader = DatasetReader(config["input"], seed=config.get("seed", 0))
        data = reader.read_all()
        returns = compute_mc_returns(
            np.asarray(data[REWARDS], np.float64),
            np.asarray(data[DONES]).astype(bool),
            config.get("gamma", 0.99))
        # z-score once over the dataset: the value head then regresses an
        # O(1) target, so its gradient through the shared trunk can't
        # drown the cloning term, and advantages start in exp()'s sweet
        # spot.  (Weighting is scale-free — only relative adv matters.)
        returns = ((returns - returns.mean())
                   / (returns.std() + 1e-8)).astype(np.float32)
        cols = dict(data)
        cols["returns"] = returns
        self._reader = reader
        self._data = SampleBatch(cols)

    def training_step(self) -> Dict[str, Any]:
        if not hasattr(self, "_batches"):
            self._batches = self._reader.iter_batches(
                self.config.get("train_batch_size", 512), data=self._data)
        policy = self.workers.local_worker.policy
        stats: Dict[str, float] = {}
        for _ in range(self.config.get("sgd_iters_per_step", 16)):
            batch = next(self._batches)
            stats = policy.learn_on_batch(batch)
            self._timesteps_total += batch.count
        self.workers.sync_weights()
        self.workers.synchronous_sample()   # evaluation metrics
        return {"info": {"learner": stats},
                **{f"learner_{k}": v for k, v in stats.items()}}
