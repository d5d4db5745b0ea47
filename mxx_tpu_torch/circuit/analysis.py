"""Circuit analysis: grouped execution plan for scheduling and estimation.

A copy of `mxx_tpu/circuit/analysis.py`: topological levels with gates
grouped by kind, so per-kind batched device programs can execute each group
in one shot and a cost estimator can cost levels by their widest group.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .circuit import PolyCircuit
from .gate import INPUT


@dataclass
class ExecutionLevel:
    level_idx: int
    groups: dict[str, list[int]] = field(default_factory=dict)

    @property
    def width(self) -> int:
        return sum(len(g) for g in self.groups.values())


@dataclass
class GroupedExecutionPlan:
    levels: list[ExecutionLevel]

    @staticmethod
    def from_circuit(circuit: PolyCircuit) -> "GroupedExecutionPlan":
        levels = []
        for idx, gate_ids in enumerate(circuit.compute_levels()):
            lvl = ExecutionLevel(idx)
            for gid in gate_ids:
                g = circuit.gates[gid]
                if g.kind == INPUT:
                    continue
                lvl.groups.setdefault(g.kind, []).append(gid)
            levels.append(lvl)
        return GroupedExecutionPlan(levels)

    @property
    def max_parallelism(self) -> int:
        return max((lvl.width for lvl in self.levels), default=0)

    def total_gates(self) -> int:
        return sum(lvl.width for lvl in self.levels)
