"""train_tokens_per_s: every token of the steps completed in the window,
over the window, which ends at the end of the step that ends it."""


def read(run):
    if "tokens_in_window" not in run:
        return None
    return run["tokens_in_window"] / run["window_s"]
