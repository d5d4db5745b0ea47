"""PRG output-range bookkeeping for decoder pipelines.

A copy of `mxx_tpu/decoder/prg.py`, after the reference's src/decoder/prg.rs:5-28: protocols carve one
conceptual Goldreich PRG output stream into named contiguous ranges (seed
refresh bits, mask coefficient bits, noise material), so every consumer draws
from a disjoint window of the same full-domain graph."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PrgRangePlan:
    """Allocates contiguous [start, start+len) windows of one PRG stream."""

    cursor: int = 0
    ranges: dict[str, tuple[int, int]] = field(default_factory=dict)

    def allocate(self, name: str, length: int) -> tuple[int, int]:
        assert name not in self.ranges, f"PRG range {name} already allocated"
        assert length > 0
        start = self.cursor
        self.cursor += length
        self.ranges[name] = (start, length)
        return (start, length)

    @property
    def total(self) -> int:
        return self.cursor

    def range_of(self, name: str) -> tuple[int, int]:
        return self.ranges[name]
