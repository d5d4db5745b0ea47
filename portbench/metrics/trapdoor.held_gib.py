"""Device memory that the trapdoor, the public matrix, the operand cache of
the sampler and the tables hold after warm-up (the fullest card), in GiB."""


def read(trace):
    held = trace["held_bytes"]
    return None if held is None else held / 2**30
