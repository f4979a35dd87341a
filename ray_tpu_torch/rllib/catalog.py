"""ModelCatalog + attention-core policy.

Port of ``ray_tpu/rllib/catalog.py``.  Design analogs: reference
``rllib/models/catalog.py:189`` (ModelCatalog: model_config -> network),
``rllib/models/torch/attention_net.py:37`` (GTrXLNet: transformer memory
with GRU-style gating) and ``recurrent_net.py`` (LSTMWrapper).  The
attention core is a fixed-window memory (a [K, E] ring carried through the
time loop), so every step has static shapes and no dynamic-length
attention mask.  Plain tensor ops: no kernel of the repo runs here.

``ModelCatalog.policy_for(config)`` routes a model config to the policy
implementation, mirroring how the reference's catalog picks
FullyConnectedNetwork / LSTMWrapper / AttentionWrapper from
``model={"use_lstm": ..., "use_attention": ...}``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.rllib.policy import _orthogonal, tree_map
from ray_tpu_torch.rllib.recurrent import (RESETS, STATE_IN,  # noqa: F401
                                           StatefulPPOPolicy,
                                           masked_seq_forward)


class ModelCatalog:
    """Route a model config to a policy implementation (reference
    ``ModelCatalog.get_model_v2``)."""

    @staticmethod
    def policy_for(config: Dict[str, Any]) -> str:
        base = config.get("policy", "ppo")
        model = config.get("model") or {}
        # Memory wrappers only exist for the PPO family here; silently
        # swapping a DQN/SAC/IMPALA policy for a PPO one would break
        # those algorithms' training_step contracts (update_target etc).
        if base == "ppo":
            if model.get("use_attention"):
                return "attention_ppo"
            if model.get("use_lstm"):
                return "recurrent_ppo"
        elif model.get("use_attention") or model.get("use_lstm"):
            raise ValueError(
                f"model memory wrappers (use_lstm/use_attention) are only "
                f"supported with the ppo policy, not {base!r}")
        return base


# ------------------------------------------------- attention (GTrXL-lite)

def attn_init(gen: torch.Generator, obs_dim: int, num_outputs: int,
              embed: int = 64, memory: int = 8,
              head_scale: float = 0.01, device="cpu") -> Dict:
    params = {
        "embed": {"w": _orthogonal(gen, (obs_dim, embed), math.sqrt(2.0)),
                  "b": torch.zeros((embed,))},
        # Relative slot embedding over the K-deep memory ring.
        "pos": torch.randn((memory, embed), generator=gen) * 0.02,
        "q": {"w": _orthogonal(gen, (embed, embed), 1.0)},
        "kv": {"w": _orthogonal(gen, (embed, 2 * embed), 1.0)},
        # GRU-style gate on the attention residual (the GTrXL trick that
        # stabilizes early RL training: start mostly-identity).
        "gate": {"w": _orthogonal(gen, (2 * embed, embed), 1.0),
                 "b": torch.full((embed,), 2.0)},   # bias>0 -> pass-through
        "pi": {"w": _orthogonal(gen, (embed, num_outputs), head_scale),
               "b": torch.zeros((num_outputs,))},
        "vf": {"w": _orthogonal(gen, (embed, 1), 1.0),
               "b": torch.zeros((1,))},
    }
    return tree_map(lambda t: t.to(device=device, dtype=torch.float32),
                    params)


def attn_step(params: Dict, state: torch.Tensor, obs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One timestep.  state [n, K, E] is a ring of the last K embeddings
    (slot K-1 = most recent); obs [n, D] -> (pi, v, new_state)."""
    x = torch.tanh(torch.addmm(params["embed"]["b"], obs,
                               params["embed"]["w"]))
    # Shift the memory and append the current embedding.
    state = torch.cat([state[:, 1:], x[:, None, :]], dim=1)
    mem = state + params["pos"][None]
    q = x @ params["q"]["w"]                          # [n, E]
    kv = mem @ params["kv"]["w"]                      # [n, K, 2E]
    keys, vals = torch.chunk(kv, 2, dim=-1)
    E = q.shape[-1]
    att = torch.softmax(
        torch.einsum("ne,nke->nk", q, keys) / math.sqrt(E), dim=-1)
    ctx = torch.einsum("nk,nke->ne", att, vals)
    g = torch.sigmoid(torch.addmm(params["gate"]["b"],
                                  torch.cat([x, ctx], dim=-1),
                                  params["gate"]["w"]))
    h = g * x + (1.0 - g) * torch.tanh(ctx)
    pi = torch.addmm(params["pi"]["b"], h, params["pi"]["w"])
    v = torch.addmm(params["vf"]["b"], h, params["vf"]["w"])[:, 0]
    return pi, v, state


def attn_seq_forward(params: Dict, state0: torch.Tensor, obs: torch.Tensor,
                     resets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major [T, n, D] forward with in-loop episode resets (same
    contract as lstm_seq_forward)."""
    return masked_seq_forward(attn_step, params, state0, obs, resets)


class AttentionPPOPolicy(StatefulPPOPolicy):
    """PPO over the windowed-attention memory core; all PPO machinery
    (act fn, update, fragment loss, state plumbing) comes from
    StatefulPPOPolicy -- only the core differs."""

    def _init_params(self, gen, obs_dim, num_outputs, config):
        model = config.get("model") or {}
        self.embed = int(model.get("attention_dim", 64))
        self.memory = int(model.get("attention_memory", 8))
        return attn_init(gen, obs_dim, num_outputs,
                         embed=self.embed, memory=self.memory)

    def _step_fn(self):
        return attn_step

    def _state_shape(self):
        return (self.memory, self.embed)
