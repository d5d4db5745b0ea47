"""Device milliseconds per call of the kernels that ops/zq_matmul.py launches."""


def read(trace):
    if trace["driver"] != "preimage":
        return None
    return trace["stage_ms"]["zq_matmul"] / trace["calls"]
