"""attention_roofline.train: the bound of the attention work the traced
steps need (a forward and a backward a layer a step, the flash bound of
``arith``), over the device time of the kernels of the ``flash`` class in
the traced window, in percent.  A forward run again by remat counts in the
time and not in the work."""

from perfbench import arith


def read(run):
    tr = run.get("trace")
    busy = tr and tr["by_class"].get("flash")
    if not busy:
        return None
    m = run["sizes"]
    bound = run["trace_steps"] * arith.attention_step_bound_s(
        run["batch"], m["num_heads"], run["seq"], m["head_dim"],
        m["num_layers"])
    return 100 * bound / busy
