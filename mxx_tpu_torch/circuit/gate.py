"""Circuit gate definitions (a copy of `mxx_tpu/circuit/gate.py`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# Gate kinds
INPUT = "Input"
ADD = "Add"
SUB = "Sub"
MUL = "Mul"
SMALL_SCALAR_MUL = "SmallScalarMul"
LARGE_SCALAR_MUL = "LargeScalarMul"
SLOT_TRANSFER = "SlotTransfer"
SLOT_REDUCE = "SlotReduce"
PUB_LUT = "PubLut"
SUB_CIRCUIT_OUTPUT = "SubCircuitOutput"
SUMMED_SUB_CIRCUIT_OUTPUT = "SummedSubCircuitOutput"


@dataclass(frozen=True)
class Gate:
    gate_id: int
    kind: str
    inputs: tuple[int, ...]
    payload: Any = None  # scalar list / lut_id / SlotTransferSpec / call info


@dataclass(frozen=True)
class SlotTransferSpec:
    """Per-destination-slot (src_slot, optional u32 scalar) pairs, with
    compact Rotation/Repeated encodings."""

    kind: str  # "explicit" | "rotation" | "repeated"
    values: tuple = ()
    diagonal: int = 0
    num_slots: int = 0
    src_slot: int = 0
    prefix_len: int = 0
    prefix_scalar: int | None = None

    @staticmethod
    def explicit(values: list[tuple[int, int | None]]) -> "SlotTransferSpec":
        return SlotTransferSpec(kind="explicit", values=tuple(values))

    @staticmethod
    def rotation(diagonal: int, num_slots: int) -> "SlotTransferSpec":
        return SlotTransferSpec(kind="rotation", diagonal=diagonal, num_slots=num_slots)

    @staticmethod
    def repeated(
        src_slot: int, num_slots: int, prefix_len: int, prefix_scalar: int | None = None
    ) -> "SlotTransferSpec":
        return SlotTransferSpec(
            kind="repeated",
            src_slot=src_slot,
            num_slots=num_slots,
            prefix_len=prefix_len,
            prefix_scalar=prefix_scalar,
        )

    def materialize(self) -> list[tuple[int, int | None]]:
        if self.kind == "explicit":
            return list(self.values)
        if self.kind == "rotation":
            ns = self.num_slots
            return [((dst + ns - (self.diagonal % ns)) % ns, None) for dst in range(ns)]
        if self.kind == "repeated":
            return [
                (self.src_slot, self.prefix_scalar if dst < self.prefix_len else None)
                for dst in range(self.num_slots)
            ]
        raise ValueError(self.kind)
