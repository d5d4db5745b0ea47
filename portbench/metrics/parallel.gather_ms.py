"""Device milliseconds per call of the copies that bring the other cards'
shards onto card 0: the traced window's peer-to-peer copies (`Memcpy PtoP`)
that ran on a card other than the cell's first, over the calls of the
window. PyTorch runs a copy between cards on the source card's stream, so
these are the gather's; the scatter of the target's columns runs on card 0."""


def read(trace):
    home = trace["devices"][0]
    seconds = sum(s for name, idx, s in trace["copies"] if "PtoP" in name and idx != home)
    if seconds <= 0 or trace["window_calls"] <= 0:
        return None
    return seconds * 1e3 / trace["window_calls"]
