"""Device milliseconds per call of the kernels that circuit/batched_eval.py launches."""


def read(trace):
    if trace["driver"] != "bgg_pass":
        return None
    return trace["stage_ms"]["batched_eval stacking"] / trace["calls"]
