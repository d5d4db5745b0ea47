"""The share of the traced window in which the program ran no operation on
the cards of the mesh cell, averaged over its cards, from a profile without
Python stacks. The harness's copies of judged answers
(`tracing.HARNESS_COPIES`) are left out: a kept answer of this cell is a
12 GB copy that fills ~0.23 s of card 0's idle time in some traced windows
and none in others. The one-card cells' reader, `device.idle_pct.preimage`,
counts them as it always has: there they overlap the program's work."""


def read(trace):
    if trace["window_s"] <= 0:
        return None
    busy = sum(trace["program_busy_s"]) / len(trace["program_busy_s"])
    return 100.0 * (1.0 - busy / trace["window_s"])
