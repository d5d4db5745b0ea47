"""Device milliseconds per call of the kernels that ChaCha20 (sampler/chacha.py) launches."""


def read(trace):
    if trace["driver"] != "preimage":
        return None
    return trace["stage_ms"]["chacha20"] / trace["calls"]
