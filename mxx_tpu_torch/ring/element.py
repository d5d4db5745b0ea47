"""Host-side ring element Z_q with arbitrary-precision modulus.

A copy of `mxx_tpu/ring/element.py` (`FinRingElem`): a plain Python-int value
mod the full composite modulus q. Used at protocol boundaries (LUT outputs,
decode thresholds); bulk data lives in device tensors instead.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FinRingElem:
    value: int
    modulus: int

    def __post_init__(self):
        object.__setattr__(self, "value", self.value % self.modulus)

    @staticmethod
    def zero(modulus: int) -> "FinRingElem":
        return FinRingElem(0, modulus)

    @staticmethod
    def one(modulus: int) -> "FinRingElem":
        return FinRingElem(1, modulus)

    @staticmethod
    def constant(modulus: int, value: int) -> "FinRingElem":
        return FinRingElem(value, modulus)

    @staticmethod
    def half_q(modulus: int) -> "FinRingElem":
        return FinRingElem((modulus + 1) // 2, modulus)

    def _check(self, other: "FinRingElem"):
        assert self.modulus == other.modulus, "modulus mismatch"

    def __add__(self, other: "FinRingElem") -> "FinRingElem":
        self._check(other)
        return FinRingElem(self.value + other.value, self.modulus)

    def __sub__(self, other: "FinRingElem") -> "FinRingElem":
        self._check(other)
        return FinRingElem(self.value - other.value, self.modulus)

    def __mul__(self, other: "FinRingElem") -> "FinRingElem":
        self._check(other)
        return FinRingElem(self.value * other.value, self.modulus)

    def __neg__(self) -> "FinRingElem":
        return FinRingElem(-self.value, self.modulus)

    def __lt__(self, other: "FinRingElem") -> bool:
        return self.value < other.value

    def __le__(self, other: "FinRingElem") -> bool:
        return self.value <= other.value

    def modulus_switch(self, new_modulus: int) -> "FinRingElem":
        """Round-scale value from q to new_q (reference finite_ring.rs:modulus_switch)."""
        v = (self.value * new_modulus + self.modulus // 2) // self.modulus
        return FinRingElem(v, new_modulus)
