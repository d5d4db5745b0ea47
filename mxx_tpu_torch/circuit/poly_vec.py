"""PolyVec: a vector of per-slot polynomial wires, evaluated slot-parallel.

A copy of `mxx_tpu/circuit/poly_vec.py` (reference: src/circuit/evaluable/
poly_vec.rs): the ground-truth wire type of slot-based circuits, whose BGG+
analogs Diamond iO evaluates. Slots live on the device of their polys.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ring.poly import Poly


@dataclass(frozen=True)
class PolyVec:
    slots: tuple[Poly, ...]

    @staticmethod
    def new(slots) -> "PolyVec":
        return PolyVec(tuple(slots))

    @staticmethod
    def const(params, values: list[int], device="cuda") -> "PolyVec":
        return PolyVec(tuple(Poly.const(params, v, device) for v in values))

    def __len__(self) -> int:
        return len(self.slots)

    def as_slice(self):
        return self.slots

    def __add__(self, other: "PolyVec") -> "PolyVec":
        return PolyVec(tuple(a + b for a, b in zip(self.slots, other.slots, strict=True)))

    def __sub__(self, other: "PolyVec") -> "PolyVec":
        return PolyVec(tuple(a - b for a, b in zip(self.slots, other.slots, strict=True)))

    def __mul__(self, other: "PolyVec") -> "PolyVec":
        return PolyVec(tuple(a * b for a, b in zip(self.slots, other.slots, strict=True)))

    def small_scalar_mul(self, params, scalar: list[int]) -> "PolyVec":
        return PolyVec(tuple(p.small_scalar_mul(params, scalar) for p in self.slots))

    def large_scalar_mul(self, params, scalar: list[int]) -> "PolyVec":
        return PolyVec(tuple(p.large_scalar_mul(params, scalar) for p in self.slots))

    def __eq__(self, other):
        if not isinstance(other, PolyVec):
            return NotImplemented
        return len(self.slots) == len(other.slots) and all(
            a == b for a, b in zip(self.slots, other.slots)
        )

    def __hash__(self):
        return id(self)
