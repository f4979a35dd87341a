"""The one traffic generator: it reads a traffic mix's parameters (a file
under ``traffic/``) and makes a run's inputs from its seed.

Token ids follow a Zipf law over the configuration's real vocabulary; which
id has which rank is fixed by the mix's ``law_seed``, so every seed speaks
the same language.  Lengths and arrival gaps are drawn once from the mix's
``sizes_seed``: every run seed gets the same set of sizes and gaps, in an
order of its own, so that the seed changes which requests come when and not
how much work there is.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _zipf(law: Dict, vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cumulative probabilities of ranks 1..vocab under p_k ~ k^-s, the
    token id of each rank)."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(law["zipf"])
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    ids = np.random.default_rng(int(law["law_seed"])).permutation(vocab)
    return cdf, ids


def train_batches(traffic: Dict, vocab: int, seed: int, device
                  ) -> torch.Tensor:
    """``pool_batches`` batches of ``[batch, seq + 1]`` token ids, int64,
    made on ``device`` from the seed: the inputs and next-token targets of
    the steps, cycled."""
    cdf, ids = _zipf(traffic["token_law"], vocab)
    n, B, S1 = traffic["pool_batches"], traffic["batch"], traffic["seq"] + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n, B, S1), generator=gen, dtype=torch.float64,
                   device=device)
    rank = torch.searchsorted(torch.from_numpy(cdf).to(device), u)
    return torch.from_numpy(ids).to(device)[rank.clamp_max(vocab - 1)]


def _lognormal_sizes(law: Dict, n: int, rng: np.random.Generator
                     ) -> np.ndarray:
    x = rng.lognormal(np.log(law["median"]), law["sigma"], n)
    return np.clip(np.round(x), law["min"], law["max"]).astype(np.int64)


def requests(traffic: Dict, vocab: int, seed: int
             ) -> List[Tuple[List[int], int]]:
    """The run's requests in order, as (prompt ids, tokens to generate):
    the mix's fixed set of ``requests`` (prompt, output) length pairs,
    permuted by the seed, each prompt drawn from the Zipf law."""
    n = traffic["requests"]
    fixed = np.random.default_rng(int(traffic["sizes_seed"]))
    prompt_len = _lognormal_sizes(traffic["prompt_len"], n, fixed)
    output_len = _lognormal_sizes(traffic["output_len"], n, fixed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cdf, ids = _zipf(traffic["token_law"], vocab)
    toks = ids[np.minimum(np.searchsorted(cdf, rng.random(
        int(prompt_len.sum()))), vocab - 1)]
    out, at = [], 0
    for i in order:
        P = int(prompt_len[i])
        out.append((toks[at:at + P].tolist(), int(output_len[i])))
        at += P
    return out
