"""The plain reference against the port, on the CPU at tiny sizes in f32:
the harness's layout, the forward, the loss and its gradients, AdamW steps,
the MoE FFN, and prefill plus paged decode against the full forward."""

import pytest
import torch

from perfbench import weights
from perfbench.reference import gpt as reference
from ray_tpu_torch.models import gpt as port
from ray_tpu_torch.ops.moe import moe_mlp

SIZES = {"vocab_size": 256, "token_vocab": 250, "max_seq_len": 128,
         "num_layers": 2, "num_heads": 4, "embed_dim": 64, "head_dim": 16,
         "mlp_dim": 256, "num_experts": 0, "expert_top_k": 0,
         "capacity_factor": 0.0, "moe_aux_coef": 0.0, "layer_norm_eps": 1e-5}
MOE = dict(SIZES, num_experts=4, expert_top_k=2, capacity_factor=1.25,
           moe_aux_coef=0.01)
HP = {"learning_rate": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
      "weight_decay": 1e-4}


def _cfg(m, **kw):
    return port.GPTConfig(
        vocab_size=m["vocab_size"], max_seq_len=m["max_seq_len"],
        num_layers=m["num_layers"], num_heads=m["num_heads"],
        embed_dim=m["embed_dim"], dtype=torch.float32,
        num_experts=m["num_experts"], expert_top_k=m["expert_top_k"] or 2,
        capacity_factor=m["capacity_factor"] or 1.25,
        moe_aux_coef=m["moe_aux_coef"], **kw)


def _tokens(B, S, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 250, (B, S), generator=g)


@pytest.mark.parametrize("m", [SIZES, MOE], ids=["dense", "moe"])
def test_layout_is_the_ports(m):
    assert weights.shape_tree(m) == port.param_shapes(_cfg(m))


def test_forward():
    params = weights.make_params(SIZES, 5, "cpu")
    toks = _tokens(2, 64)
    ours = reference.GPT(SIZES).logits(params, toks)
    theirs = port.gpt_forward(params, toks, _cfg(SIZES, attention="dense"))
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [SIZES, MOE], ids=["dense", "moe"])
def test_loss_and_grads(m):
    toks = _tokens(2, 65)
    p_ref = weights.make_params(m, 5, "cpu")
    p_port = weights.make_params(m, 5, "cpu")
    leaves_ref = [t.requires_grad_(True) for _, t in
                  weights.named_leaves(p_ref)]
    leaves_port = [t.requires_grad_(True) for _, t in
                   weights.named_leaves(p_port)]
    loss_ref = reference.GPT(m).loss(p_ref, toks)
    loss_port = port.gpt_loss(p_port, {"tokens": toks},
                              _cfg(m, attention="flash", ce_block=16,
                                   remat_policy="dots"))
    torch.testing.assert_close(loss_ref, loss_port, rtol=1e-5, atol=1e-6)
    for a, b in zip(torch.autograd.grad(loss_ref, leaves_ref),
                    torch.autograd.grad(loss_port, leaves_port)):
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-4 * float(b.abs().max()) + 1e-9)


@pytest.mark.parametrize("m", [SIZES, MOE], ids=["dense", "moe"])
def test_adamw_steps(m):
    batches = [_tokens(2, 65, seed) for seed in (1, 2)]
    ref = reference.train_readings(m, weights.make_params(m, 5, "cpu"),
                                   batches, HP)
    params = weights.make_params(m, 5, "cpu")
    leaves = [t.requires_grad_(True) for _, t in
              weights.named_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=HP["learning_rate"],
                            betas=tuple(HP["betas"]), eps=HP["eps"],
                            weight_decay=HP["weight_decay"])
    step = port.make_train_step(_cfg(m, attention="dense"), opt)
    losses = [float(step(params, {"tokens": b})["loss"]) for b in batches]
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for name, p in weights.named_leaves(params):
        change = weights.slice_norms(
            name, p.detach() - weights.make_leaf(m, 5, name, "cpu"))
        torch.testing.assert_close(change, ref["change"][name], rtol=2e-3,
                                   atol=1e-9)


def test_moe_ffn():
    g = torch.Generator().manual_seed(9)
    h = torch.randn(3, 40, 64, generator=g)
    p = {k: v[0] for k, v in weights.make_params(MOE, 4, "cpu")["layers"]
         ["mlp"].items()}
    p["bi"] = torch.randn(p["bi"].shape, generator=g) * 0.1
    ours, aux_ours = reference.GPT(MOE).moe(h, p)
    theirs, aux_theirs = moe_mlp(h, p, top_k=2, capacity_factor=1.25)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux_ours, aux_theirs)


def test_prefill_and_paged_decode_match_the_full_forward():
    params = weights.make_params(SIZES, 6, "cpu")
    cfg = _cfg(SIZES)
    toks = _tokens(1, 40)[0].tolist()
    full = reference.GPT(SIZES).logits(params, torch.tensor([toks]))[0]
    page, maxp, prompt = 8, 8, 24
    k, v = port.init_paged_cache(cfg, 1 + maxp, page, device="cpu")
    table = torch.arange(1, maxp + 1)[None]
    padded = torch.zeros((1, 32), dtype=torch.int64)
    padded[0, :prompt] = torch.tensor(toks[:prompt])
    logits, k, v = port.gpt_prefill(params, cfg, padded, prompt, k, v, table)
    torch.testing.assert_close(logits[0], full[prompt - 1], rtol=1e-4,
                               atol=1e-4)
    for pos in range(prompt, len(toks)):
        logits, k, v = port.gpt_decode_step(
            params, cfg, torch.tensor([toks[pos]]), torch.tensor([pos]),
            k, v, table)
        torch.testing.assert_close(logits[0], full[pos], rtol=1e-4,
                                   atol=1e-4)
