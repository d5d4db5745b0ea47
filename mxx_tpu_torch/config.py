"""Environment-variable configuration: the circuit evaluator's knob, copied
from `mxx_tpu/config.py` with the same variable name."""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def circuit_live_bytes_budget() -> int:
    """Device-resident wire budget for the batched circuit evaluator; idle
    wires beyond it spill to host compact bytes. 0 = unbounded."""
    return _env_int("MXX_CIRCUIT_LIVE_BYTES_BUDGET", 0)
