"""elementwise_ms_per_step.train: device ms of the element-wise and copy
kernels (class ``elementwise_copy``) in the traced window, per step."""


def read(run):
    tr = run.get("trace")
    if not tr or not run.get("trace_steps"):
        return None
    return 1e3 * tr["by_class"].get("elementwise_copy", 0.0) \
        / run["trace_steps"]
