"""Recurrent (LSTM) policy support for PPO.

Port of ``ray_tpu/rllib/recurrent.py``.  Design analog: reference
``rllib/models/torch/recurrent_net.py`` (LSTMWrapper: obs embed -> LSTM
-> pi/vf heads) and the sequence-aware PPO loss in ``torch_policy_v2.py``
(time-major forward with per-episode state resets).  The cell is written
out here rather than taken from ``nn.LSTM``, whose gate layout and biases
differ: the weight tree stays the JAX package's (one fused ``[E+H, 4H]``
kernel for the gates i, f, g, o, and a +1.0 forget bias in the cell).
The sequence forward is a time loop with the resets; the update is the
reference's epochs of full-fragment steps as a Python loop.

State plumbing mirrors the reference's sampler contract: the rollout
worker snapshots the hidden state at fragment start (``state_in``),
carries it across steps, and zeroes finished envs' rows; the learner
replays the same resets in its loop via the shifted ``dones`` mask.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.policy import (OptaxAdam, TorchPolicy, _orthogonal,
                                        host_batch, normalized_advantages,
                                        stats_to_floats, to_tensors,
                                        tree_leaves, tree_map,
                                        tree_unflatten, value_and_grad)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP,
                                              ADVANTAGES, OBS,
                                              VALUE_TARGETS, VF_PREDS)

STATE_IN = "state_in"       # [n, 2, H] fragment-start LSTM state
RESETS = "resets"           # [T, n] 1.0 where state must zero BEFORE step t


# -- LSTM actor-critic ----------------------------------------------------

def lstm_init(gen: torch.Generator, obs_dim: int, num_outputs: int,
              embed: int = 64, hidden: int = 64,
              head_scale: float = 0.01, device="cpu") -> Dict:
    params = {
        "embed": {"w": _orthogonal(gen, (obs_dim, embed), math.sqrt(2.0)),
                  "b": torch.zeros((embed,))},
        # One fused kernel for the 4 gates (i, f, g, o): [E+H, 4H].
        "lstm": {"w": _orthogonal(gen, (embed + hidden, 4 * hidden), 1.0),
                 "b": torch.zeros((4 * hidden,))},
        "pi": {"w": _orthogonal(gen, (hidden, num_outputs), head_scale),
               "b": torch.zeros((num_outputs,))},
        "vf": {"w": _orthogonal(gen, (hidden, 1), 1.0),
               "b": torch.zeros((1,))},
    }
    return tree_map(lambda t: t.to(device=device, dtype=torch.float32),
                    params)


def _lstm_cell(params, h, c, x):
    z = torch.addmm(params["lstm"]["b"], torch.cat([x, h], dim=-1),
                    params["lstm"]["w"])
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_step(params: Dict, state: torch.Tensor, obs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One timestep: state [n, 2, H], obs [n, D] -> (pi, v, new_state)."""
    x = torch.tanh(torch.addmm(params["embed"]["b"], obs,
                               params["embed"]["w"]))
    h, c = _lstm_cell(params, state[:, 0], state[:, 1], x)
    pi = torch.addmm(params["pi"]["b"], h, params["pi"]["w"])
    v = torch.addmm(params["vf"]["b"], h, params["vf"]["w"])[:, 0]
    return pi, v, torch.stack([h, c], dim=1)


def masked_seq_forward(step_fn, params: Dict, state0: torch.Tensor,
                       obs: torch.Tensor, resets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major sequence forward with in-loop episode resets, generic
    over the per-step core (LSTM, attention ring, ...).

    obs [T, n, D], resets [T, n] (1.0 zeroes the carried state before
    consuming obs[t] -- i.e. env n finished at t-1).  -> pi [T, n, O],
    v [T, n]."""
    state, pis, vs = state0, [], []
    for t in range(obs.shape[0]):
        state = state * (1.0 - resets[t])[:, None, None]
        pi, v, state = step_fn(params, state, obs[t])
        pis.append(pi)
        vs.append(v)
    return torch.stack(pis), torch.stack(vs)


def lstm_seq_forward(params, state0, obs, resets):
    return masked_seq_forward(lstm_step, params, state0, obs, resets)


# -- policy ---------------------------------------------------------------

class StatefulPPOPolicy(TorchPolicy):
    """Shared PPO machinery for policies with a carried per-env state
    (LSTM core, attention-memory core); trains on [T, n] fragments.

    Subclasses provide the core: ``_init_params(gen, obs_dim,
    num_outputs, config)``, ``_step_fn()`` (the (params, state, obs) ->
    (pi, v, state) function), and ``_state_shape()`` (trailing dims of
    the per-env state).  Everything else -- the act fn, the sequence loss
    over ``masked_seq_forward``, the epoch loop, the rollout-side state
    plumbing -- lives here once.

    The update is epochs x full-fragment gradient steps (sequences cannot
    be flat-shuffled).
    """

    recurrent = True

    def _init_params(self, gen, obs_dim: int, num_outputs: int,
                     config: Dict[str, Any]):
        raise NotImplementedError

    def _step_fn(self):
        raise NotImplementedError

    def _state_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        self._setup(action_space, config, seed)
        self.params = tree_map(
            lambda t: t.to(self.device),
            self._init_params(self._init_gen, obs_dim, self.num_outputs,
                              config))
        self._step = self._step_fn()
        self._opt = OptaxAdam(tree_leaves(self.params),
                              config.get("lr", 3e-4),
                              clip=config.get("grad_clip", 0.5))
        self._state = None      # lazy: [n, *state_shape] once n is known
        self._clip = config.get("clip_param", 0.2)
        self._vf_coeff = config.get("vf_loss_coeff", 0.5)
        self._ent_coeff = config.get("entropy_coeff", 0.01)
        self._num_epochs = config.get("num_sgd_iter", 4)

    @torch.no_grad()
    def _act(self, params, gen, state, obs):
        pi, v, state = self._step(params, state, obs)
        actions = self.dist.sample(gen, pi)
        return actions, self.dist.logp(pi, actions), v, state

    def _loss(self, params, batch):
        dist, clip = self.dist, self._clip
        pi, v = masked_seq_forward(self._step, params, batch[STATE_IN],
                                   batch[OBS], batch[RESETS])
        T, n = v.shape
        flat_pi = pi.reshape((T * n,) + pi.shape[2:])
        acts = batch[ACTIONS].reshape((T * n,) + batch[ACTIONS].shape[2:])
        logp = dist.logp(flat_pi, acts).reshape(T, n)
        ratio = torch.exp(logp - batch[ACTION_LOGP])
        adv = batch[ADVANTAGES]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        vf_err = (v - batch[VALUE_TARGETS]) ** 2
        entropy = dist.entropy(flat_pi)
        total = (-torch.mean(surr) + self._vf_coeff * torch.mean(vf_err)
                 - self._ent_coeff * torch.mean(entropy))
        return total, {"policy_loss": -torch.mean(surr),
                       "vf_loss": torch.mean(vf_err),
                       "entropy": torch.mean(entropy),
                       "total_loss": total}

    # -- rollout side -----------------------------------------------------

    def _ensure_state(self, n: int):
        if self._state is None or self._state.shape[0] != n:
            self._state = torch.zeros((n,) + self._state_shape(),
                                      device=self.device)

    def state_snapshot(self) -> np.ndarray:
        return self._state.cpu().numpy().copy()

    def notify_dones(self, done: np.ndarray) -> None:
        """Zero finished envs' state (worker calls after each step)."""
        if done.any():
            mask = torch.as_tensor(~done, dtype=torch.float32,
                                   device=self.device)[:, None, None]
            self._state = self._state * mask

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        self._ensure_state(obs.shape[0])
        actions, logp, v, self._state = self._act(
            self.params, self._act_gen, self._state, self._obs(obs))
        return {ACTIONS: actions.cpu().numpy(),
                ACTION_LOGP: logp.cpu().numpy(), VF_PREDS: v.cpu().numpy()}

    @torch.no_grad()
    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        """Value at the CURRENT state without advancing it (bootstrap)."""
        self._ensure_state(obs.shape[0])
        _, v, _ = self._step(self.params, self._state, self._obs(obs))
        return v.cpu().numpy()

    # -- learner side -----------------------------------------------------

    def learn_on_batch(self, batch) -> Dict[str, float]:
        tensors = to_tensors(host_batch(normalized_advantages(batch)),
                             self.device)
        params, stats = self.params, {}
        for _ in range(self._num_epochs):
            stats, grads = value_and_grad(
                lambda p: self._loss(p, tensors), params)
            params = tree_unflatten(params, self._opt.step(
                tree_leaves(params), grads))
        self.params = params
        return stats_to_floats(stats)


class RecurrentPPOPolicy(StatefulPPOPolicy):
    """PPO over the fused-gate LSTM core (reference LSTMWrapper)."""

    def _init_params(self, gen, obs_dim, num_outputs, config):
        self.hidden = int(config.get("lstm_cell_size", 64))
        return lstm_init(gen, obs_dim, num_outputs,
                         embed=int(config.get("lstm_embed", 64)),
                         hidden=self.hidden)

    def _step_fn(self):
        return lstm_step

    def _state_shape(self):
        return (2, self.hidden)
