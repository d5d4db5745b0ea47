"""How unevenly the cards of a cell were busy over the traced window: the
most busy card's busy time less the least busy card's, over the most busy
card's, in %, from the device-only profile's busy seconds per card without
the harness's copies of judged answers (`tracing.HARNESS_COPIES`), which
land on card 0 in some traced windows and not in others."""


def read(trace):
    busy = trace["program_busy_s"]
    if len(busy) < 2 or max(busy) <= 0:
        return None
    return 100.0 * (max(busy) - min(busy)) / max(busy)
