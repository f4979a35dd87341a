#!/usr/bin/env python3
"""The longer run of ROADMAP C1: does bf16 flash agree with bf16 dense on
top-1 once GPT-2-small's attention carries the answer?

    python3 scripts/torch_top1_induction.py
    python3 scripts/torch_top1_induction.py --paths dense,flash --lr 3e-4 \
        --clip 1.0 --text-rows 0 --copy-rows 16

Trains GPT-2-small (bf16, remat "dots", blocked cross-entropy, AdamW) on
the copy corpus of ``chip_smoke.py``'s ``top1_trained`` phase for many
more steps than that phase takes: each step's batch is 8 windows of 1024
bytes of the repository's ``*.md`` files and 8 windows of seeded spans of
64 bytes, each followed by its copy.  A copy byte can only be predicted by
attending 64 positions back (an induction head).  It trains twice from the
same seed: once with flash attention, then once with dense attention, the
control that tells a fault of the flash training path from a copy that
neither path learns.  After each, on held-out windows of each corpus, it
prints the phase's figures (``chip_smoke.top1_figures``): the f32
forward's cross-entropy beside the unigram and bigram baselines, bf16
top-1 agreement of flash with dense and of each with f32, the bf16 logit
error and f32 top-2 gaps over all logits and over the 256 byte logits, and
``c1_holds`` (loss 0.3 nats under the better baseline, flash with dense on
99% of the positions).  One JSON line with the card's name and power
limit, then per training a phase line and a ``{"trained_with": ...}``
summary.  Needs a CUDA card: it exits nonzero without one.

The options set the recipe; with none it is the first run's (3,000 steps,
lr 1e-3 after 100 warmup steps, no clipping, 8 text and 8 copy rows,
flash then dense).  ``--text-rows 0`` trains on the seeded copy corpus
alone, a corpus that does not change with the repository's documents;
``--clip`` clips the global grad norm before each AdamW step; ``--paths``
names the attention paths to train, in order.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The run: 3,000 steps of 16 rows of 1024 tokens (~50 M tokens), lr 1e-3
# after 100 warmup steps, 16 held-out windows of each corpus.
STEPS, LR, WARMUP, EVAL_ROWS = 3000, 1e-3, 100, 16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--clip", type=float, default=None,
                    help="clip the global grad norm to this (default: no "
                    "clipping)")
    ap.add_argument("--text-rows", type=int, default=8)
    ap.add_argument("--copy-rows", type=int, default=8)
    ap.add_argument("--eval-rows", type=int, default=EVAL_ROWS)
    ap.add_argument("--paths", default="flash,dense",
                    help="attention paths to train, in order")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_top1_induction: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ray_tpu_torch.models import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": chip_smoke.nvidia_smi_line(),
                      "torch": torch.__version__}), flush=True)
    rows = args.text_rows + args.copy_rows
    for attention in args.paths.split(","):
        cfg = dataclasses.replace(GPTConfig.gpt2_small(),
                                  attention=attention, remat=True,
                                  remat_policy="dots", ce_block=256)
        fields = chip_smoke.phase_top1_trained(
            dev, cfg, None, B=args.text_rows, steps=args.steps, lr=args.lr,
            warmup=args.warmup, copy_rows=args.copy_rows,
            eval_rows=args.eval_rows, clip=args.clip)
        print(json.dumps({"trained_with": attention,
                          "c1_closed": fields["c1_closed"],
                          "copy_trained": fields["copy_task"]["trained"],
                          "steps": args.steps,
                          "tokens": args.steps * rows * 1024,
                          "train_s": fields["train_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
