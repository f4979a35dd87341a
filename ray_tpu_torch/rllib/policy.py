"""Policies: torch actor-critic networks + the Policy contract.

Port of ``ray_tpu/rllib/policy.py``.  Design analog: reference
``rllib/policy/policy.py`` + ``torch_policy_v2.py`` (compute_actions /
loss / learn_on_batch / get-set_weights).  The network is a plain dict of
tensors in the JAX package's layout (``{"trunk0": {"w": [in, out], "b"},
..., "pi", "vf"}``, ``x @ w + b``), so ``get_weights()`` returns the JAX
package's tree as numpy f32 and ``set_weights`` takes one (through
``weights_from_jax``).

The params are never changed in place: an update computes new tensors and
publishes them by assigning ``self.params`` once it is done, as the JAX
package's immutable arrays are.  A reader on another thread (the policy
server) therefore always sees one whole set of weights.  Each policy owns
its generators, seeded from its ``seed``: the init draws from a CPU
generator (the same init on the CPU and on the card), actions from one on
the policy's device, and PPO's minibatch permutations from CPU generators,
so the same update runs the same minibatches on either device.  The
update loop is the reference's ``lax.scan`` over epochs x minibatches as
a Python loop of the same steps in the same order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ACTION_LOGP, ADVANTAGES, OBS, SampleBatch, VALUE_TARGETS,
    VF_PREDS)

Tree = Dict[str, Any]


# -- params trees (dicts, lists and tuples of tensors, leaves in
# jax.tree.leaves order: dict keys sorted, lists and tuples in index order;
# an empty container has no leaves) ------------------------------------------

def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(like, leaves: Sequence[Any]):
    """A tree shaped like ``like`` holding ``leaves`` (tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(n) for n in node)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return tuple(tree.shape)


def weights_from_jax(tree, device, like: Optional[Tree] = None) -> Tree:
    """The JAX package's weight tree (numpy or jax arrays, f32; dicts,
    lists and tuples) as f32 tensors on ``device``.  Checks that every
    leaf is a float32 array (0-d included), that each ``{"w", "b"}`` layer
    has ``b.shape == (w.shape[1],)``, and, when ``like`` is given, that
    the structure and shapes are ``like``'s."""
    def check(node, path):
        if isinstance(node, dict):
            if "w" in node and "b" in node:
                w, b = np.shape(node["w"]), np.shape(node["b"])
                if len(w) != 2 or b != (w[1],):
                    raise ValueError(f"{path}: w {w} and b {b} do not make "
                                     f"a layer")
            for k, v in node.items():
                check(v, f"{path}/{k}")
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                check(v, f"{path}/{i}")
            return
        dtype = getattr(node, "dtype", None)
        if dtype is None or np.dtype(str(dtype)) != np.float32:
            raise TypeError(f"{path}: leaf of dtype {dtype}, want float32")
    check(tree, "")
    if like is not None and _shapes(tree) != _shapes(like):
        raise ValueError(f"weights {_shapes(tree)} do not match the "
                         f"policy's {_shapes(like)}")
    dev = torch.device(device)
    return tree_map(lambda x: torch.as_tensor(np.array(x, np.float32),
                                              device=dev), tree)


def tree_to_numpy(tree: Tree) -> Tree:
    """The tree as numpy f32 copies (the JAX package's get_weights)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy()
                    .copy(), tree)


def value_and_grad(loss_fn: Callable, params: Tree
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """``loss_fn(params) -> (loss, stats)`` and the grads of the loss
    w.r.t. the leaves of ``params`` (tree_leaves order); a leaf the loss
    does not read (BC's value head) gets zeros, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, stats = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in stats.items()}, grads


def stats_to_floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for all stats."""
    vals = torch.stack([v.reshape(()).float() for v in stats.values()])
    return dict(zip(stats, vals.tolist()))


# -- optimizer --------------------------------------------------------------

class OptaxAdam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr))``, or
    ``optax.adam(lr)`` when ``clip`` is None, over a list of leaves.

    The clip is optax's: grads scale by ``clip / norm`` only when the
    global norm is at least ``clip`` (``torch.nn.utils.clip_grad_norm_``
    scales by ``clip / (norm + 1e-6)``), decided on the device, with no
    host sync.  Adam's eps stays outside the square root, as optax's does.
    ``step`` returns new leaves and leaves its inputs as they were.
    """

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float,
                 clip: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    def step(self, leaves: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        grads = list(grads)
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        return torch._foreach_add(list(leaves), mu_hat, alpha=-self.lr)


# -- actor-critic network (shared tanh trunk, logits + value heads) -------

def _orthogonal(gen: torch.Generator, shape, scale) -> torch.Tensor:
    """Orthogonal init (standard for PPO; keeps early policy near-uniform).
    Drawn on the CPU from ``gen``."""
    a = torch.randn(shape, generator=gen)
    q, r = torch.linalg.qr(a if shape[0] >= shape[1] else a.T)
    q = q * torch.sign(torch.diagonal(r))
    if shape[0] < shape[1]:
        q = q.T
    return scale * q[:shape[0], :shape[1]]


def ac_init(gen: torch.Generator, obs_dim: int, num_outputs: int,
            hiddens=(64, 64), value_head: bool = True,
            head_scale: float = 0.01, device="cpu") -> Tree:
    params, sizes = {}, (obs_dim,) + tuple(hiddens)
    for i in range(len(hiddens)):
        params[f"trunk{i}"] = {
            "w": _orthogonal(gen, (sizes[i], sizes[i + 1]), math.sqrt(2.0)),
            "b": torch.zeros((sizes[i + 1],))}
    params["pi"] = {"w": _orthogonal(gen, (sizes[-1], num_outputs),
                                     head_scale),
                    "b": torch.zeros((num_outputs,))}
    if value_head:
        params["vf"] = {"w": _orthogonal(gen, (sizes[-1], 1), 1.0),
                        "b": torch.zeros((1,))}
    return tree_map(lambda t: t.to(device=device, dtype=torch.float32),
                    params)


def _flatten_obs(obs: torch.Tensor) -> torch.Tensor:
    """Image observations (e.g. the 10x10xC MinAtar-class envs) flatten at
    the network boundary; vector obs pass through."""
    return obs.reshape(obs.shape[0], -1) if obs.dim() > 2 else obs


def _trunk(params: Tree, obs: torch.Tensor) -> torch.Tensor:
    x = _flatten_obs(obs)
    i = 0
    while f"trunk{i}" in params:
        p = params[f"trunk{i}"]
        x = torch.tanh(torch.addmm(p["b"], x, p["w"]))
        i += 1
    return x


def head_forward(params: Tree, obs: torch.Tensor) -> torch.Tensor:
    """Trunk + pi head only (Q-values for DQN-style policies)."""
    return torch.addmm(params["pi"]["b"], _trunk(params, obs),
                       params["pi"]["w"])


def ac_forward(params: Tree, obs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pi_out [B, num_outputs], value [B])."""
    x = _trunk(params, obs)
    pi = torch.addmm(params["pi"]["b"], x, params["pi"]["w"])
    v = torch.addmm(params["vf"]["b"], x, params["vf"]["w"])[:, 0]
    return pi, v


# -- distributions --------------------------------------------------------

class Categorical:
    """Discrete action head over logits."""

    @staticmethod
    def sample(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    @staticmethod
    def logp(logits, actions):
        return torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            actions[:, None].long())[:, 0]

    @staticmethod
    def entropy(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)


class DiagGaussian:
    """Continuous action head: first half means, second half log-stds."""

    @staticmethod
    def split(out):
        d = out.shape[-1] // 2
        return out[..., :d], torch.clamp(out[..., d:], -5.0, 2.0)

    @staticmethod
    def sample(gen: torch.Generator, out):
        mean, log_std = DiagGaussian.split(out)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(out, actions):
        mean, log_std = DiagGaussian.split(out)
        var = torch.exp(2 * log_std)
        ll = -0.5 * ((actions - mean) ** 2 / var
                     + 2 * log_std + math.log(2 * math.pi))
        return torch.sum(ll, dim=-1)

    @staticmethod
    def entropy(out):
        _, log_std = DiagGaussian.split(out)
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)


# -- GAE ------------------------------------------------------------------

def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_values: np.ndarray, gamma: float, lam: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over [T, N] rollout arrays.

    ``dones`` cuts bootstrapping at episode ends; ``last_values`` bootstraps
    the final step.  Host-side numpy, copied from the JAX package.
    Reference analog: rllib/evaluation/postprocessing.py
    compute_gae_for_sample_batch.
    """
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    lastgaelam = np.zeros_like(last_values)
    nextvalues = last_values
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t].astype(rewards.dtype)
        delta = rewards[t] + gamma * nextvalues * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
        nextvalues = values[t]
    return adv, adv + values


def host_batch(batch) -> Dict[str, np.ndarray]:
    """numpy columns as the learner reads them: f32 but for actions."""
    return {k: np.asarray(v, None if k == ACTIONS else np.float32)
            for k, v in batch.items()}


def to_tensors(arrays: Dict[str, np.ndarray], device
               ) -> Dict[str, torch.Tensor]:
    """Tensors on ``device``; on the CPU they share the arrays' memory
    unless an array is read-only (a batch straight from the object
    store), which is copied."""
    def one(v):
        v = np.ascontiguousarray(v)
        return v if v.flags.writeable else v.copy()
    return {k: torch.as_tensor(one(v), device=device)
            for k, v in arrays.items()}


def normalized_advantages(batch) -> Dict[str, np.ndarray]:
    """The batch with advantages standardized over the whole batch in f32
    numpy, as the JAX package does before its update."""
    adv = np.asarray(batch[ADVANTAGES], np.float32)
    out = dict(batch)
    out[ADVANTAGES] = (adv - adv.mean()) / (adv.std() + 1e-8)
    return out


# -- Policy ---------------------------------------------------------------

class Policy:
    """Contract the rollout worker and learner drive."""

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights):
        raise NotImplementedError


class TorchPolicy(Policy):
    """What every torch policy here shares: the device from
    ``config["device"]`` (None: the first card, raising without one), the
    action distribution, the generators and the weight I/O.  Subclasses
    set ``self.params`` (a tree of f32 tensors on ``self.device``) and
    replace it, never change it in place."""

    def _setup(self, action_space, config: Dict[str, Any], seed: int):
        self.config = config
        self.seed = seed
        self.device = resolve_device(config.get("device"))
        self.discrete = action_space.kind == "discrete"
        self.dist = Categorical if self.discrete else DiagGaussian
        self.num_outputs = (action_space.n if self.discrete
                            else 2 * int(np.prod(action_space.shape)))
        self._init_gen = torch.Generator().manual_seed(seed)
        self._act_gen = torch.Generator(device=self.device).manual_seed(
            seed)

    def _obs(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def get_weights(self):
        return tree_to_numpy(self.params)

    def set_weights(self, weights):
        self.params = weights_from_jax(weights, self.device,
                                       like=self.params)


class ActorCriticPolicy(TorchPolicy):
    """PPO's and A2C's shared part: the ``ac_init`` network with a value
    head, sampled actions with their logp and values, and optax's clipped
    Adam."""

    def _init_actor_critic(self, obs_dim: int, action_space,
                           config: Dict[str, Any], seed: int, lr: float):
        self._setup(action_space, config, seed)
        self.params = ac_init(self._init_gen, obs_dim, self.num_outputs,
                              tuple(config.get("hiddens", (64, 64))),
                              device=self.device)
        self._opt = OptaxAdam(tree_leaves(self.params),
                              config.get("lr", lr),
                              clip=config.get("grad_clip", 0.5))

    @torch.no_grad()
    def _act(self, params, gen, obs):
        pi, v = ac_forward(params, obs)
        actions = self.dist.sample(gen, pi)
        return actions, self.dist.logp(pi, actions), v

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        actions, logp, v = self._act(self.params, self._act_gen,
                                     self._obs(obs))
        return {ACTIONS: actions.cpu().numpy(),
                ACTION_LOGP: logp.cpu().numpy(), VF_PREDS: v.cpu().numpy()}

    @torch.no_grad()
    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        _, v = ac_forward(self.params, self._obs(obs))
        return v.cpu().numpy()


class PPOPolicy(ActorCriticPolicy):
    """Actor-critic PPO policy over a dict of tensors.

    The minibatch-SGD update (``_update``) runs epochs x minibatches of the
    clipped-surrogate + value + entropy loss.  With
    ``num_learner_devices=n`` the batch splits into n equal shards
    (``learner.py``): each shard takes minibatches of ``mb_size // n`` rows
    in its own permutation, the shards' grads are averaged each minibatch
    step (the reference's ``pmean``) and one optimizer step updates the
    replicated params.
    """

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        from ray_tpu_torch.rllib.learner import learner_devices, perm_gens
        self._init_actor_critic(obs_dim, action_space, config, seed, 3e-4)
        self._n_learn = int(config.get("num_learner_devices", 1) or 1)
        self._devices = learner_devices(self._n_learn, self.device)
        # Permutations come from CPU generators, one a shard: the same
        # update runs the same minibatches on the CPU and on the card.
        self._perm_gens = perm_gens(seed, self._n_learn)
        self._clip = config.get("clip_param", 0.2)
        self._vf_coeff = config.get("vf_loss_coeff", 0.5)
        self._ent_coeff = config.get("entropy_coeff", 0.01)
        self._vf_clip = config.get("vf_clip_param", 10.0)
        self._num_epochs = config.get("num_sgd_iter", 4)
        self._mb_size = config.get("sgd_minibatch_size", 128)

    def _loss(self, params, mb):
        dist, clip, vf_clip = self.dist, self._clip, self._vf_clip
        pi, v = ac_forward(params, mb[OBS])
        logp = dist.logp(pi, mb[ACTIONS])
        ratio = torch.exp(logp - mb[ACTION_LOGP])
        adv = mb[ADVANTAGES]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        # Pessimistic vf clip: MAX of unclipped / clipped squared error
        # (min would zero the gradient exactly when v drifts furthest).
        vf_err = torch.maximum(
            (v - mb[VALUE_TARGETS]) ** 2,
            (mb[VF_PREDS] + torch.clamp(v - mb[VF_PREDS], -vf_clip, vf_clip)
             - mb[VALUE_TARGETS]) ** 2)
        entropy = dist.entropy(pi)
        total = (-torch.mean(surr) + self._vf_coeff * torch.mean(vf_err)
                 - self._ent_coeff * torch.mean(entropy))
        stats = {"policy_loss": -torch.mean(surr),
                 "vf_loss": torch.mean(vf_err),
                 "entropy": torch.mean(entropy),
                 "total_loss": total,
                 "approx_kl": torch.mean(mb[ACTION_LOGP] - logp)}
        return total, stats

    def _prepare(self, batch) -> List[Dict[str, torch.Tensor]]:
        from ray_tpu_torch.rllib.learner import shard_rows, trim_batch
        batch = normalized_advantages(batch)
        if self._n_learn > 1:
            batch = trim_batch(batch, self._n_learn)
        shards = shard_rows(host_batch(batch), self._n_learn)
        return [to_tensors(s, d) for s, d in zip(shards, self._devices)]

    def _plan(self, shards):
        """Minibatch size and count a shard (the reference's: the global
        ``sgd_minibatch_size`` split over the shards)."""
        n = shards[0][OBS].shape[0]
        mb = min(max(1, self._mb_size // self._n_learn), n)
        return mb, n // mb

    def _epoch_perms(self, n: int) -> List[torch.Tensor]:
        return [torch.randperm(n, generator=g).to(d)
                for g, d in zip(self._perm_gens, self._devices)]

    def _minibatch_step_grads(self, params, shards, perms, j, mb):
        from ray_tpu_torch.rllib.learner import dp_value_and_grad
        mbs = [{k: v[p[j * mb:(j + 1) * mb]] for k, v in s.items()}
               for s, p in zip(shards, perms)]
        return dp_value_and_grad(self._loss, params, mbs, self._devices)

    def _update(self, shards) -> Dict[str, torch.Tensor]:
        mb, num_mb = self._plan(shards)
        n = shards[0][OBS].shape[0]
        params, stats = self.params, {}
        for _ in range(self._num_epochs):
            perms = self._epoch_perms(n)
            for j in range(num_mb):
                stats, grads = self._minibatch_step_grads(params, shards,
                                                          perms, j, mb)
                params = tree_unflatten(params, self._opt.step(
                    tree_leaves(params), grads))
        self.params = params
        return stats

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        return stats_to_floats(self._update(self._prepare(batch)))

    def first_minibatch(self, batch: SampleBatch
                        ) -> Tuple[Dict[str, float], Tree]:
        """The stats and grads (numpy tree) of the first minibatch step
        ``learn_on_batch(batch)`` would take, from the current params.
        Changes nothing: the permutation generators are put back.  For
        holding one device's update against another's."""
        states = [g.get_state() for g in self._perm_gens]
        shards = self._prepare(batch)
        mb, _ = self._plan(shards)
        perms = self._epoch_perms(shards[0][OBS].shape[0])
        for g, s in zip(self._perm_gens, states):
            g.set_state(s)
        stats, grads = self._minibatch_step_grads(self.params, shards,
                                                  perms, 0, mb)
        return stats_to_floats(stats), tree_to_numpy(
            tree_unflatten(self.params, grads))
