"""Plain PyTorch GPT-2, dense or with a GShard top-k MoE FFN, in f32: the
benchmark's reference for the port's training step and serving path.

It follows the published equations and imports nothing of the program:
pre-norm blocks (layer norm in f32, eps 1e-5), causal softmax attention over
``[B, N, S, H]``, GELU (tanh form, GPT-2's ``gelu_new``), a head tied to the
token table, next-token cross-entropy; the MoE FFN routes each token to its
top-k experts by a softmax router (ties to the lower expert), renormalises
the k gates, fills each expert's ``C = int(cf S k / E)`` slots per row in
order (every first choice before any second), drops what overflows, and
adds the Switch load-balance loss ``E sum_e f_e p_e`` over the top-1 choices
times its coefficient.  AdamW is written out.  Departures from GPT-2, which
the port shares: no bias on the qkv projection; a vocabulary padded to the
configuration's size.

``low=True`` computes every matrix product as fp8 training does (the
hybrid format): its operands rounded to e4m3 and, in the backward, the
gradient that reaches its output rounded to e5m2, each under one scale a
tensor, products and sums in f32: the control that a comparison has to
fail.  Products run with TF32 off; each block and each
chunk of the head is checkpointed, so a step at the timed sizes fits beside
its optimizer state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.weights import named_leaves, slice_norms

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale (amax to 448); the
    gradient passes straight through."""
    xd = x.detach()
    return x + (_round(xd, torch.float8_e4m3fn, E4M3_MAX) - xd)


class _E5M2Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 (amax to 57344)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def capacity(S: int, k: int, E: int, cf: float) -> int:
    return max(1, int(cf * S * k / E))


def layer_norm(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


class GPT:
    """The model of a configuration's sizes (``weights.sizes``)."""

    def __init__(self, m: Dict, low: bool = False, head_rows: int = 2):
        self.m, self.low, self.head_rows = m, low, head_rows

    def mm(self, a, b):
        if not self.low:
            return torch.matmul(a, b)
        return _E5M2Grad.apply(torch.matmul(fp8_round(a), fp8_round(b)))

    def attention(self, q, k, v):
        S, H = q.shape[-2], q.shape[-1]
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(H)
        causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        return self.mm(torch.softmax(scores, dim=-1), v)

    def moe(self, h, p):
        m = self.m
        B, S, D = h.shape
        E, k = m["num_experts"], m["expert_top_k"]
        C = capacity(S, k, E, m["capacity_factor"])
        probs = torch.softmax(self.mm(h, p["router"]), dim=-1)   # [B, S, E]
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gates = gates[..., :k] / gates[..., :k].sum(-1, keepdim=True)
        experts = experts[..., :k]
        filled = torch.zeros((B, E), dtype=torch.int64, device=h.device)
        weight = torch.zeros((B, S, E), device=h.device)
        for i in range(k):
            choice = F.one_hot(experts[..., i], E)               # [B, S, E]
            slot = choice.cumsum(dim=1) - 1 + filled[:, None, :]
            filled = filled + choice.sum(dim=1)
            kept = (choice > 0) & (slot < C)
            weight = weight + kept * gates[..., i, None]
        y = torch.zeros_like(h)
        for e in range(E):
            rows = (weight[..., e] > 0).nonzero(as_tuple=True)
            if rows[0].numel() == 0:
                continue
            he = h[rows]
            out = self.mm(gelu_new(self.mm(he, p["wi"][e]) + p["bi"][e]),
                          p["wo"][e]) + p["bo"][e]
            y = y.index_put(rows, weight[..., e][rows][:, None] * out,
                            accumulate=True)
        top1 = F.one_hot(experts[..., 0], E).float()
        aux = E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        return y, aux

    def block(self, x, p):
        m = self.m
        B, S, D = x.shape
        N, H, eps = m["num_heads"], m["head_dim"], m["layer_norm_eps"]
        h = layer_norm(x, p["ln1"], eps)
        qkv = self.mm(h, p["attn"]["wqkv"].reshape(D, 3 * N * H))
        qkv = qkv.view(B, S, 3, N, H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = self.attention(q, k, v).transpose(1, 2).reshape(B, S, N * H)
        x = x + self.mm(o, p["attn"]["wo"].reshape(N * H, D)) \
            + p["attn"]["bo"]
        h = layer_norm(x, p["ln2"], eps)
        if m["num_experts"]:
            f, aux = self.moe(h, p["mlp"])
        else:
            mp = p["mlp"]
            f = self.mm(gelu_new(self.mm(h, mp["wi"]) + mp["bi"]),
                        mp["wo"]) + mp["bo"]
            aux = torch.zeros((), device=x.device)
        return x + f, aux

    def hidden(self, params, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (final hidden [B, S, D], summed aux loss)."""
        S = tokens.shape[1]
        x = params["wte"][tokens] + params["wpe"][:S]
        aux = torch.zeros((), device=x.device)
        grad = torch.is_grad_enabled()
        for l in range(self.m["num_layers"]):
            p = _layer(params["layers"], l)
            x, a = (checkpoint(self.block, x, p, use_reentrant=False)
                    if grad else self.block(x, p))
            aux = aux + a
        return layer_norm(x, params["ln_f"], self.m["layer_norm_eps"]), aux

    def logits(self, params, tokens) -> torch.Tensor:
        x, _ = self.hidden(params, tokens)
        return self.mm(x, params["wte"].t())

    def _chunk_nll(self, x, wte, targets):
        logits = self.mm(x, wte.t())
        picked = logits.gather(-1, targets[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    def loss(self, params, tokens) -> torch.Tensor:
        """Mean next-token cross-entropy of tokens [B, S + 1], plus the
        MoE load-balance loss times its coefficient."""
        x, aux = self.hidden(params, tokens[:, :-1])
        targets = tokens[:, 1:]
        nll = sum(checkpoint(self._chunk_nll, xc, params["wte"], tc,
                             use_reentrant=False)
                  for xc, tc in zip(x.split(self.head_rows),
                                    targets.split(self.head_rows)))
        loss = nll / targets.numel()
        if self.m["num_experts"]:
            loss = loss + self.m["moe_aux_coef"] * aux
        return loss


def _layer(tree, l):
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def train_readings(m: Dict, params, batches: Sequence[torch.Tensor],
                   hp: Dict, low: bool = False) -> Dict:
    """Steps of AdamW from ``params`` (changed in place) over ``batches``:
    each step's loss, each leaf part's gradient norm at the first step
    (``weights.slice_norms``), and each part's change after the last."""
    model = GPT(m, low)
    names = [n for n, _ in named_leaves(params)]
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    start = [t.detach().clone() for t in leaves]
    m1 = [torch.zeros_like(t) for t in leaves]
    m2 = [torch.zeros_like(t) for t in leaves]
    lr, wd, eps = hp["learning_rate"], hp["weight_decay"], hp["eps"]
    b1, b2 = hp["betas"]
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, start=1):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if t == 1:
            grad_norms = {n: slice_norms(n, g) for n, g in zip(names, grads)}
        with torch.no_grad():
            for p, g, a, s in zip(leaves, grads, m1, m2):
                p.mul_(1 - lr * wd)
                a.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (s.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(a, denom, value=-lr / (1 - b1 ** t))
        del grads
    change = {n: slice_norms(n, p.detach() - p0)
              for n, p, p0 in zip(names, leaves, start)}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def served_gaps(m: Dict, params, sequences: List[Tuple[List[int], List[int]]],
                low: bool = False) -> Tuple[float, float]:
    """Over (prompt, served tokens) pairs: (the widest gap by which a
    served token's f32 logit lies below the f32 best at its position; with
    ``low``, the widest gap of the token the fp8 control puts first there
    instead)."""
    ref, ctl = GPT(m), GPT(m, low=True)
    worst_served, worst_low = 0.0, 0.0
    with torch.no_grad():
        for prompt, served in sequences:
            seq = torch.tensor([list(prompt) + list(served[:-1])],
                               device=params["wte"].device)
            logits = ref.logits(params, seq)[0, len(prompt) - 1:]
            best = logits.max(dim=-1).values
            tok = torch.tensor(served, device=logits.device)
            gap = best - logits.gather(-1, tok[:, None])[:, 0]
            worst_served = max(worst_served, float(gap.max()))
            if low:
                pick = ctl.logits(params, seq)[0, len(prompt) - 1:].argmax(-1)
                gap = best - logits.gather(-1, pick[:, None])[:, 0]
                worst_low = max(worst_low, float(gap.max()))
    return worst_served, worst_low

