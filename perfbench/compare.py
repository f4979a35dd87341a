"""The numbers that decide ``correct``, from the program's readings and the
reference's.

Training (``train_numbers``): the program's first steps, as set-up ran them
through the window's own call, against the reference's steps from the same
weights and batches.
- ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the steps.
- ``grad_gap``: the worst leaf part (a layer's slice of a stacked leaf, or a
  whole leaf) of | |g| - |g_ref| | / max(|g_ref|, the median part's
  |g_ref|), g the first step's gradient (the program's as AdamW holds it:
  its first moment over 1 - beta1).
- ``change_gap``: the same of each part's change over the steps, leaving
  out parts whose reference gradient is under a thousandth of the median
  part's (they move under Adam by round-off alone).

- ``grad_leaf_gap``, ``change_leaf_gap``: the same by whole leaf (a stacked
  leaf's layer slices together), the median leaf's reference norm as the
  floor, and for the change the rule above on leaves.

The gradient and change gaps also as steadier variants, ``*_median`` and
``*_p90`` (the median part's gap, the 90th percentile's, in place of the
worst), for a cell whose worst part swings from seed to seed (an MoE's
router, whose bf16 routing differs from f32's at near-tied tokens).  Which
numbers a cell compares is its limits file's choice.

Serving (``reference.gpt.served_gaps``): ``logit_gap``, the widest gap by
which a served token's reference logit lies below the reference's best.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

SMALL_GRAD = 1e-3


def _median(t: torch.Tensor) -> torch.Tensor:
    """The median as ``statistics.median`` gives it: the mean of the two
    middle values of an even count (``Tensor.median`` takes the lower)."""
    return torch.quantile(t, 0.5)


def _flat(parts: Dict[str, torch.Tensor]) -> Tuple[List[str], torch.Tensor]:
    names, vals = [], []
    for name, t in parts.items():
        t = t.cpu().double()
        names += [f"{name}[{i}]" if t.numel() > 1 else name
                  for i in range(t.numel())]
        vals.append(t.reshape(-1))
    return names, torch.cat(vals)


def _gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
          keep: torch.Tensor) -> Tuple[torch.Tensor, List[str]]:
    names, p = _flat(prog)
    _, r = _flat(ref)
    floor = _median(r[keep])
    gaps = (p - r).abs() / torch.maximum(r, floor)
    return gaps[keep], [n for n, k in zip(names, keep.tolist()) if k]


def _whole(parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's norm from its parts' norms."""
    return {name: t.double().norm().reshape(1) for name, t in parts.items()}


def _part_gaps(prefix, prog, ref, keep) -> Dict[str, Tuple]:
    gaps, names = _gaps(prog, ref, keep)
    i = int(gaps.argmax())
    return {prefix: (float(gaps[i]), names[i]),
            prefix + "_median": (float(_median(gaps)), "median part"),
            prefix + "_p90": (float(torch.quantile(gaps, 0.9)), "p90 part")}


def _leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    g_ref = _whole(ref["grad_norms"])
    _, r = _flat(g_ref)
    every = torch.ones_like(r, dtype=torch.bool)
    moved = r >= SMALL_GRAD * _median(r)
    return {**_part_gaps("grad_leaf_gap", _whole(prog["grad_norms"]), g_ref,
                         every),
            **_part_gaps("change_leaf_gap", _whole(prog["change"]),
                         _whole(ref["change"]), moved)}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of the program's readings against the
    reference's (``reference.gpt.train_readings``'s format)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]
    step = max(range(len(losses)), key=losses.__getitem__)
    _, g_ref = _flat(ref["grad_norms"])
    every = torch.ones_like(g_ref, dtype=torch.bool)
    moved = g_ref >= SMALL_GRAD * _median(g_ref)
    return {"loss_gap": (losses[step], f"step {step + 1}"),
            **_part_gaps("grad_gap", prog["grad_norms"],
                                ref["grad_norms"], every),
            **_part_gaps("change_gap", prog["change"], ref["change"],
                                moved),
            **_leaf_gaps(prog, ref)}

