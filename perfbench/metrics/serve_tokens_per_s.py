"""serve_tokens_per_s: every token handed to a client in the window, over
the window."""

from perfbench.readings import window_tokens


def read(run):
    if "requests" not in run:
        return None
    return sum(1 for _ in window_tokens(run)) / run["window_s"]
