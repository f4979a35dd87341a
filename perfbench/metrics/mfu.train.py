"""mfu.train: model FLOPs (6 N + 12 L S D a token; an MoE by the params a
token uses) of the steps in the traced window, over the traced window x the
card's bf16 peak, in percent."""

from perfbench import arith


def read(run):
    tr = run.get("trace")
    if not tr or not run.get("trace_steps"):
        return None
    flops = (run["trace_steps"] * run["tokens_per_step"] * 1e6
             * arith.train_mflop_per_token(run["sizes"], run["seq"],
                                           run["n_params"]))
    return 100 * flops / (tr["window_s"] * arith.PEAK_FLOPS["bfloat16"])
