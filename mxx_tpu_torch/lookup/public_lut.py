"""Public lookup table: a copy of `mxx_tpu/lookup/public_lut.py`.

A LUT maps an input value x in [0, len) to (output row index k, output value
y_k in Z_q). The function is closure-backed so large tables need not be
materialized; `max_output_row` records the entry with the largest y (used by
norm simulation).
"""

from __future__ import annotations

from typing import Callable

from ..ring.element import FinRingElem
from ..ring.params import RingParams


class PublicLut:
    def __init__(
        self,
        params: RingParams,
        length: int,
        f: Callable[[RingParams, int], tuple[int, FinRingElem] | None],
        max_output_row: tuple[int, FinRingElem] | None = None,
    ):
        self.f = f
        self.length = length
        if max_output_row is None:
            max_output_row = max(
                ((self.get_checked(params, x)) for x in range(length)), key=lambda kv: kv[1].value
            )
        self.max_output_row = max_output_row

    def __len__(self) -> int:
        return self.length

    def get(self, params: RingParams, x: int) -> tuple[int, FinRingElem] | None:
        return self.f(params, x)

    def get_checked(self, params: RingParams, x: int) -> tuple[int, FinRingElem]:
        out = self.f(params, x)
        if out is None:
            raise KeyError(f"LUT entry {x} missing from 0..len range")
        return out

    def entries(self, params: RingParams):
        for x in range(self.length):
            yield x, self.get_checked(params, x)

    @staticmethod
    def from_dict(params: RingParams, table: dict[int, tuple[int, int]]) -> "PublicLut":
        """Build from {x: (row_k, y_int)}."""
        q = params.modulus
        frozen = {x: (k, FinRingElem(y, q)) for x, (k, y) in table.items()}
        return PublicLut(params, len(table), lambda _p, x: frozen.get(x))
