"""The share of the traced window in which no operation ran on the device,
from a profile without Python stacks (averaged over the cards used)."""


def read(trace):
    if trace["driver"] != "preimage" or trace["window_s"] <= 0:
        return None
    busy = sum(trace["busy_s"]) / len(trace["busy_s"])
    return 100.0 * (1.0 - busy / trace["window_s"])
