"""tokens_per_step.serve: tokens handed to clients by the decode steps of
the window, over their number: the steps the engine's counter
(``stats()["steps"]``) took over the window, each token known by the
counter read when it arrived."""


def read(run):
    if "steps_window" not in run:
        return None
    s0, s1 = run["steps_window"]
    if s1 <= s0:
        return None
    tokens = sum(1 for r in run["requests"] for k, s in enumerate(r["steps"])
                 if k > 0 and s0 < s <= s1)
    return tokens / (s1 - s0)
