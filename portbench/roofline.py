"""The least time of the negacyclic transforms a call needs, on one H100.

A transform of P polynomials of degree n (the shapes each cell counted once
and froze in `cells/<cell>.json`) needs at least the larger of:

- bytes: every residue read once and written once at 4 bytes (every
  modulus is below 2^31), 8 P n bytes over the H100 SXM's 3.35 TB/s of HBM;
- integer instructions: n/2 log2(n) butterfly products per polynomial (the
  merged-twist algorithm folds the psi twist into the twiddles, and the
  inverse's n^-1 into its last stage), each with the fewest 32-bit integer
  instructions a known exact method needs: 7 for Harvey's butterfly (2014,
  "Faster arithmetic for number-theoretic transforms") with Shoup's
  precomputed quotient: a high and two low multiply-adds for the product,
  one add, one three-input add for the difference, and a subtract and a
  minimum to keep the lazy input below 2q (valid for q < 2^30). The H100
  issues 64 int32 instructions per SM per clock: 64 x 132 x 1.98e9 per s.

Counting fewer products or bytes than a kernel needs only lowers the bound,
so the share of it stays at or below 100% for any implementation.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_PER_S = 64 * 132 * 1.98e9
BYTES_PER_RESIDUE_READ_AND_WRITTEN = 8
INSTR_PER_BUTTERFLY = 7


def transform_bound_ms(shape: list[int]) -> float:
    """Least milliseconds of one transform over a [..., n] tensor."""
    n = shape[-1]
    polys = math.prod(shape[:-1])
    bytes_ms = BYTES_PER_RESIDUE_READ_AND_WRITTEN * polys * n / HBM_BYTES_PER_S * 1e3
    int_ms = polys * (n // 2) * (n.bit_length() - 1) * INSTR_PER_BUTTERFLY / INT32_PER_S * 1e3
    return max(bytes_ms, int_ms)


def call_bound_ms(counts: dict) -> float:
    """Least milliseconds of the transforms of one call of a cell."""
    return sum(t["count"] * transform_bound_ms(t["shape"]) for t in counts["transforms_per_call"])
