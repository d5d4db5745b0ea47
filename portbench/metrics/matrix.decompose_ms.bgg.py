"""Device milliseconds per call of the kernels that ops/decompose.py launches."""


def read(trace):
    if trace["driver"] != "bgg_pass":
        return None
    return trace["stage_ms"]["digit_decompose"] / trace["calls"]
