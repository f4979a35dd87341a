"""mfu.serve: the share of the card's peak that the window's work needs,
in percent: the sum over the window's decode steps and prefills of the
larger of FLOPs over the bf16 peak and bytes over the memory rate
(``arith.decode_step_work``, ``arith.prefill_work``: the weights once a
step at bf16, the keys and values of each live position, the prompt's true
length), over the window.  A decode step is known by the engine's step
counter read with each token it handed over (the window's steps are those
the counter took over it); its token k of a prompt of P attended P + k
keys.  A prefill counts when its first token arrived in the window."""

from perfbench import arith
from perfbench.readings import window_tokens


def read(run):
    if "steps_window" not in run:
        return None
    m, (s0, s1) = run["sizes"], run["steps_window"]
    busy, steps = 0.0, {}
    for r, k in window_tokens(run):
        if k == 0:
            busy += arith.bound_s(*arith.prefill_work(m, r["prompt_len"]))
    for r in run["requests"]:
        for k, s in enumerate(r["steps"]):
            if k > 0 and s0 < s <= s1:
                steps.setdefault(s, []).append(r["prompt_len"] + k)
    for contexts in steps.values():
        busy += arith.bound_s(*arith.decode_step_work(m, contexts))
    return 100 * busy / run["window_s"]
