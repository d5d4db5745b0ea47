"""The transforms' share of their roofline: the least time of the transforms
one call needs (counted once and frozen in the cell's file; roofline.py) over
the device time of the transforms stage per call (K1, K2, K3 by name, and
the radix chain)."""


def read(trace):
    bound, ms = trace["transform_bound_ms"], trace["stage_ms"]["transforms"]
    if trace["driver"] != "bgg_pass" or bound is None or ms <= 0:
        return None
    return 100.0 * bound / (ms / trace["calls"])
