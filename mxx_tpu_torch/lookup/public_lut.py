"""Public lookup table: a copy of `mxx_tpu/lookup/public_lut.py`.

A LUT maps an input value x in [0, len) to (output row index k, output value
y_k in Z_q). The function is closure-backed so large tables need not be
materialized; `max_output_row` records the entry with the largest y (used by
norm simulation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

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


def lut_input_values(params: RingParams, polys) -> list[int]:
    """The constant values of many LUT input plaintexts (on one device) with
    ONE device-to-host copy: column 0 of each, stacked."""
    if any(p is None for p in polys):
        raise ValueError("LUT input must reveal its plaintext")
    return const_values(params, torch.stack([p.data[:, 0] for p in polys], dim=1))


def const_values(params: RingParams, cols: torch.Tensor) -> list[int]:
    """The constant values of B constant plaintexts from column 0 of their
    residues, [L, B] (either form: a constant's evaluations all equal it),
    with one device-to-host copy; each distinct column is reconstructed
    once."""
    uniq, inv = np.unique(cols.T.cpu().numpy(), axis=0, return_inverse=True)
    vals = [int(params.reconstruct_coeff(c)) for c in uniq]
    return [vals[i] for i in inv.reshape(-1)]
