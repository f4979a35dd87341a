"""Offline kernel-autotune sweep: fill the persistent autotune cache for a
fleet's attention shapes, once, on a CUDA card.

    python -m ray_tpu_torch.autotune.sweep              # default shape set
    python -m ray_tpu_torch.autotune.sweep --shapes 32x1024x12x64 2x4096x32x128
    python -m ray_tpu_torch.autotune.sweep --allow-cpu  # plain versions (CI)

Each shape is BxSxNxH (batch x seq x heads x head_dim).  For every shape
the sweep tunes each applicable variant's own config (the splash block
set where the shape admits it) and persists the per-variant records plus
the crossover winner (``attention_variant``) to $RT_AUTOTUNE_CACHE
(default ~/.cache/ray_tpu/autotune.jsonl).  Ship that file to the fleet
and every worker dispatches from measured timings with no warm-up.

Exits 2 when no CUDA device is present (pass --allow-cpu to sweep the
plain versions on the CPU instead, which checks the plumbing), 1 when no
variant ran at any shape.
"""

import argparse
import json
import sys

# The training shape (B=32, S=1024), the long-context curve points of the
# repo's bench, and Llama 2 7B's attention (32 heads of 128, a 4096
# context), the one shape here where splash applies.
DEFAULT_SHAPES = ("32x1024x12x64", "2x4096x12x64", "1x8192x12x64",
                  "1x16384x12x64", "1x32768x12x64", "2x4096x32x128")


def parse_shape(s: str):
    parts = [int(x) for x in s.lower().split("x")]
    if len(parts) != 4:
        raise argparse.ArgumentTypeError(
            f"shape {s!r} is not BxSxNxH (e.g. 2x8192x12x64)")
    return tuple(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", type=parse_shape,
                    default=[parse_shape(s) for s in DEFAULT_SHAPES],
                    help="BxSxNxH shapes to tune (default: bench set)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--no-causal", action="store_true")
    ap.add_argument("--budget-s", type=float, default=120.0,
                    help="per-shape tuning budget, seconds")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="sweep the plain versions when no card is present")
    ap.add_argument("--force", action="store_true",
                    help="re-tune shapes that already have cache records")
    ap.add_argument("--compact", action="store_true",
                    help="rewrite the cache file to one line per key")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available() and not args.allow_cpu:
        print("autotune sweep: no CUDA device; pass --allow-cpu to sweep "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    device = "cuda" if torch.cuda.is_available() else "cpu"

    from ray_tpu_torch.autotune import backend_fingerprint, cache_path
    from ray_tpu_torch.autotune import get_cache
    from ray_tpu_torch.autotune.dispatch import tune_attention

    causal = not args.no_causal
    print(f"autotune sweep: backend={backend_fingerprint(device)} "
          f"cache={cache_path()}")
    failed = 0
    for (B, S, N, H) in args.shapes:
        rec = tune_attention(B, S, N, H, args.dtype, causal, device=device,
                             budget_s=args.budget_s, force=args.force)
        if rec is None:
            failed += 1
            print(f"  {B}x{S}x{N}x{H}: no variant ran", file=sys.stderr)
            continue
        print(f"  {B}x{S}x{N}x{H}: {json.dumps(rec['config'])} "
              f"{rec.get('ms')}ms  "
              f"timings={json.dumps((rec.get('meta') or {}).get('timings'))}")
    cache = get_cache()
    if args.compact:
        n = cache.rewrite()
        print(f"autotune sweep: compacted to {n} records")
    print(f"autotune sweep: cache holds {len(cache)} records "
          f"({cache.path})")
    return 1 if failed == len(args.shapes) else 0


if __name__ == "__main__":
    sys.exit(main())
