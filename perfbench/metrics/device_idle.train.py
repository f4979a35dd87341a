"""The device's idle share: the part of the traced window in which no
operation ran on the card (the union of their intervals), in percent."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
