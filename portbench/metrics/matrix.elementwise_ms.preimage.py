"""Device milliseconds per call of the elementwise Z_q ops (ops/elementwise.py
and matrix/poly_matrix.py)."""


def read(trace):
    if trace["driver"] != "preimage":
        return None
    return trace["stage_ms"]["elementwise"] / trace["calls"]
