"""CKKS-style modulus switching over nested-RNS values: a copy of
`mxx_tpu/gadgets/mod_switch.py` (host code).

- `drop_levels`: restrict a NestedRnsPoly to a smaller active q-window
  (exact, wire-level: the value is reinterpreted mod the smaller product);
- host-side `rescale_value` (round(value * q'/q)) and the induced error bound
  used by the mod-switch simulation.
"""

from __future__ import annotations

import math
from dataclasses import replace
from decimal import Decimal

from .arith.nested_rns import NestedRnsPoly


def drop_levels(poly: NestedRnsPoly, keep_levels: int) -> NestedRnsPoly:
    """Keep the first `keep_levels` q-levels of the active window."""
    assert 0 < keep_levels <= poly.levels
    return replace(
        poly,
        wires=poly.wires[:keep_levels],
        enable_levels=keep_levels,
        value_bounds=poly.value_bounds[:keep_levels],
        trace_bounds=poly.trace_bounds[:keep_levels],
    )


def rescale_value(value: int, from_moduli: list[int], to_moduli: list[int]) -> int:
    """round(value * Q_to / Q_from) mod Q_to — the CKKS rescale on plain ints."""
    q_from = math.prod(from_moduli)
    q_to = math.prod(to_moduli)
    return (value * q_to + q_from // 2) // q_from % q_to


def rescale_error_bound(num_levels_dropped: int, ring_dim_sqrt: Decimal) -> Decimal:
    """Added rounding error per rescale: <= 1/2 per dropped level times the
    ring expansion factor."""
    return Decimal(num_levels_dropped) * ring_dim_sqrt / 2
