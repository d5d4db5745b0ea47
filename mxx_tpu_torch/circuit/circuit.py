"""Circuit DAG IR, construction and evaluation.

A copy of `mxx_tpu/circuit/circuit.py` (it imports only `gate`). Wire ids are
gate indices; gate 0 is the implicit constant-one input wire supplied
separately at eval.

Evaluation runs over any `Evaluable`-like wire type: objects supporting
__add__/__sub__/__mul__ plus small_scalar_mul/large_scalar_mul (and optional
matrix_mul). Plain `Poly`, `BggPublicKey` and `BggEncoding` all qualify, so
the plaintext evaluation is the oracle of the other two.

The host-side scheduler evaluates gates in topological (id) order, freeing
wires by use count. `eval(batched=True)` hands the circuit to the
level-batched evaluator (`batched_eval.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .gate import (
    ADD,
    INPUT,
    LARGE_SCALAR_MUL,
    MUL,
    PUB_LUT,
    SLOT_REDUCE,
    SLOT_TRANSFER,
    SMALL_SCALAR_MUL,
    SUB,
    SUB_CIRCUIT_OUTPUT,
    SUMMED_SUB_CIRCUIT_OUTPUT,
    Gate,
    SlotTransferSpec,
)


# Sub-circuit parameter kinds
PARAM_SMALL_SCALAR_MUL = "SmallScalarMul"
PARAM_LARGE_SCALAR_MUL = "LargeScalarMul"
PARAM_SLOT_TRANSFER = "SlotTransfer"

_PARAM = "param"  # payload marker for param-sourced gate payloads


@dataclass
class SubCircuitCall:
    """One call of a registered sub-circuit with its parameter bindings."""

    sub_circuit_id: int
    inputs: tuple[int, ...]
    param_bindings: tuple
    output_gate_ids: list[int] = field(default_factory=list)


@dataclass
class SummedSubCircuitCall:
    """N calls of the same sub-circuit whose outputs are summed."""

    sub_circuit_id: int
    call_inputs: tuple[tuple[int, ...], ...]
    param_bindings: tuple  # one bindings tuple per call
    output_gate_ids: list[int] = field(default_factory=list)


class BatchedWire:
    """A contiguous gate-id range returned by `input(n)`. Behaves as a list
    of gate ids, plus the `.at(i)` / `.as_single_wire()` idioms."""

    __slots__ = ("start", "count")

    def __init__(self, start: int, count: int):
        self.start = start
        self.count = count

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(range(self.start, self.start + self.count))

    def __getitem__(self, idx):
        ids = list(range(self.start, self.start + self.count))
        return ids[idx]

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __eq__(self, other):
        return list(self) == list(other)

    def at(self, idx: int) -> "BatchedWire":
        assert 0 <= idx < self.count
        return BatchedWire(self.start + idx, 1)

    def as_single_wire(self) -> int:
        assert self.count == 1, "as_single_wire requires a 1-wide range"
        return self.start

    def __repr__(self):
        return f"BatchedWire({self.start}..{self.start + self.count})"


@dataclass
class PolyCircuit:
    """Gate 0 is the reserved constant-one input wire; `input(n)` creates
    the n user-input wires after it
    and `num_input` counts user inputs only."""

    gates: list[Gate] = field(default_factory=lambda: [Gate(0, INPUT, ())])
    num_input: int = 0
    output_ids: list[int] = field(default_factory=list)
    luts: dict[int, Any] = field(default_factory=dict)
    sub_circuits: dict[int, "PolyCircuit"] = field(default_factory=dict)
    sub_circuit_calls: dict[int, SubCircuitCall] = field(default_factory=dict)
    summed_sub_circuit_calls: dict[int, SummedSubCircuitCall] = field(default_factory=dict)
    sub_circuit_params: list[str] = field(default_factory=list)

    # -------------------------------------------------------- construction

    def _new_gate(self, kind: str, inputs: list[int], payload=None) -> int:
        gid = len(self.gates)
        for i in inputs:
            assert 0 <= i < gid, f"gate {gid} references future wire {i}"
        self.gates.append(Gate(gid, kind, tuple(inputs), payload))
        return gid

    def input(self, num_input: int) -> "BatchedWire":
        assert all(g.kind == INPUT for g in self.gates), "inputs must be created first"
        start = len(self.gates)
        for _ in range(num_input):
            self._new_gate(INPUT, [])
        self.num_input += num_input
        return BatchedWire(start, num_input)

    def num_gates(self) -> int:
        return len(self.gates)

    @property
    def num_output(self) -> int:
        return len(self.output_ids)

    def output(self, outputs: list[int]):
        self.output_ids.extend(outputs)

    def const_one_gate(self) -> int:
        return 0

    def const_zero_gate(self) -> int:
        return self.not_gate(0)

    def const_minus_one_gate(self) -> int:
        zero = self.const_zero_gate()
        return self.sub_gate(zero, 0)

    def const_digits(self, digits: list[int]) -> int:
        return self.small_scalar_mul(self.const_one_gate(), digits)

    def const_poly(self, poly) -> int:
        return self.large_scalar_mul(self.const_one_gate(), poly.coeffs())

    def add_gate(self, left: int, right: int) -> int:
        return self._new_gate(ADD, [left, right])

    def sub_gate(self, left: int, right: int) -> int:
        return self._new_gate(SUB, [left, right])

    def mul_gate(self, left: int, right: int) -> int:
        return self._new_gate(MUL, [left, right])

    def small_scalar_mul(self, input_id: int, scalar: list[int]) -> int:
        return self._new_gate(SMALL_SCALAR_MUL, [input_id], tuple(int(s) for s in scalar))

    def large_scalar_mul(self, input_id: int, scalar: list[int]) -> int:
        return self._new_gate(LARGE_SCALAR_MUL, [input_id], tuple(int(s) for s in scalar))

    def poly_scalar_mul(self, input_id: int, poly) -> int:
        return self.large_scalar_mul(input_id, poly.coeffs())

    def rotate_gate(self, input_id: int, shift: int) -> int:
        scalar = [0] * (shift + 1)
        scalar[shift] = 1
        return self.small_scalar_mul(input_id, scalar)

    # boolean helpers over bit-valued wires

    def and_gate(self, l: int, r: int) -> int:
        return self.mul_gate(l, r)

    def not_gate(self, i: int) -> int:
        return self.sub_gate(0, i)

    def or_gate(self, l: int, r: int) -> int:
        return self.sub_gate(self.add_gate(l, r), self.mul_gate(l, r))

    def nand_gate(self, l: int, r: int) -> int:
        return self.not_gate(self.and_gate(l, r))

    def nor_gate(self, l: int, r: int) -> int:
        return self.not_gate(self.or_gate(l, r))

    def xor_gate(self, l: int, r: int) -> int:
        s = self.add_gate(l, r)
        two_lr = self.add_gate(self.mul_gate(l, r), self.mul_gate(l, r))
        return self.sub_gate(s, two_lr)

    def xnor_gate(self, l: int, r: int) -> int:
        return self.not_gate(self.xor_gate(l, r))

    def register_public_lut(self, lut) -> int:
        lut_id = len(self.luts)
        self.luts[lut_id] = lut
        return lut_id

    # ---------------------------------------------------------- sub-circuits

    def fresh_sub_circuit(self) -> "PolyCircuit":
        """New circuit sharing this circuit's LUT registry (registry handles
        are inherited so lut_ids are globally consistent across parent and
        children)."""
        sub = PolyCircuit()
        sub.luts = self.luts
        return sub

    def register_sub_circuit_param(self, kind: str) -> int:
        assert kind in (PARAM_SMALL_SCALAR_MUL, PARAM_LARGE_SCALAR_MUL, PARAM_SLOT_TRANSFER)
        self.sub_circuit_params.append(kind)
        return len(self.sub_circuit_params) - 1

    def small_scalar_mul_param(self, input_id: int, param_id: int) -> int:
        assert self.sub_circuit_params[param_id] == PARAM_SMALL_SCALAR_MUL
        return self._new_gate(SMALL_SCALAR_MUL, [input_id], (_PARAM, param_id))

    def large_scalar_mul_param(self, input_id: int, param_id: int) -> int:
        assert self.sub_circuit_params[param_id] == PARAM_LARGE_SCALAR_MUL
        return self._new_gate(LARGE_SCALAR_MUL, [input_id], (_PARAM, param_id))

    def slot_transfer_gate_param(self, input_id: int, param_id: int) -> int:
        assert self.sub_circuit_params[param_id] == PARAM_SLOT_TRANSFER
        return self._new_gate(SLOT_TRANSFER, [input_id], (_PARAM, param_id))

    def register_sub_circuit(self, sub: "PolyCircuit") -> int:
        if sub.luts is not self.luts and sub.luts:
            for lid, lut in sub.luts.items():
                assert lid not in self.luts or self.luts[lid] is lut, (
                    "LUT id clash between parent and sub-circuit; use fresh_sub_circuit()"
                )
                self.luts[lid] = lut
        sub.luts = self.luts
        cid = len(self.sub_circuits)
        self.sub_circuits[cid] = sub
        return cid

    def call_sub_circuit(
        self, circuit_id: int, inputs: list[int], param_bindings: tuple = ()
    ) -> list[int]:
        sub = self.sub_circuits[circuit_id]
        assert len(inputs) == sub.num_input, (len(inputs), sub.num_input)
        assert len(param_bindings) == len(sub.sub_circuit_params)
        call_id = len(self.sub_circuit_calls)
        call = SubCircuitCall(circuit_id, tuple(inputs), tuple(param_bindings))
        self.sub_circuit_calls[call_id] = call
        out_ids = []
        for out_idx in range(sub.num_output):
            gid = self._new_gate(SUB_CIRCUIT_OUTPUT, list(inputs), (call_id, out_idx))
            out_ids.append(gid)
        call.output_gate_ids = out_ids
        return out_ids

    def call_sub_circuit_sum_many(
        self,
        circuit_id: int,
        call_inputs: list[list[int]],
        param_bindings_list: list[tuple] | None = None,
    ) -> list[int]:
        sub = self.sub_circuits[circuit_id]
        assert call_inputs, "summed call requires at least one input set"
        if param_bindings_list is None:
            param_bindings_list = [()] * len(call_inputs)
        assert len(param_bindings_list) == len(call_inputs)
        for ins, pb in zip(call_inputs, param_bindings_list):
            assert len(ins) == sub.num_input
            assert len(pb) == len(sub.sub_circuit_params)
        summed_id = len(self.summed_sub_circuit_calls)
        call = SummedSubCircuitCall(
            circuit_id,
            tuple(tuple(s) for s in call_inputs),
            tuple(tuple(pb) for pb in param_bindings_list),
        )
        self.summed_sub_circuit_calls[summed_id] = call
        flat = [w for s in call_inputs for w in s]
        out_ids = []
        for out_idx in range(sub.num_output):
            gid = self._new_gate(SUMMED_SUB_CIRCUIT_OUTPUT, flat, (summed_id, out_idx))
            out_ids.append(gid)
        call.output_gate_ids = out_ids
        return out_ids

    def public_lookup_gate(self, input_id: int, lut_id: int) -> int:
        return self._new_gate(PUB_LUT, [input_id], lut_id)

    def slot_transfer_gate(self, input_id: int, src_slots: list[tuple[int, int | None]]) -> int:
        return self._new_gate(SLOT_TRANSFER, [input_id], SlotTransferSpec.explicit(src_slots))

    def slot_transfer_gate_spec(self, input_id: int, spec: SlotTransferSpec) -> int:
        return self._new_gate(SLOT_TRANSFER, [input_id], spec)

    def slot_reduce_gate(self, input_ids: list[int], num_slots: int) -> int:
        assert 0 < len(input_ids) <= num_slots
        return self._new_gate(SLOT_REDUCE, list(input_ids), num_slots)

    # ------------------------------------------------------------ analysis

    def gate_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for g in self.gates:
            out[g.kind] = out.get(g.kind, 0) + 1
        return out

    def use_counts(self) -> list[int]:
        uses = [0] * len(self.gates)
        for g in self.gates:
            for i in g.inputs:
                uses[i] += 1
        for o in self.output_ids:
            uses[o] += 1
        return uses

    def compute_levels(self) -> list[list[int]]:
        """Topological levels (gates with equal depth)."""
        depth = [0] * len(self.gates)
        for g in self.gates:
            if g.inputs:
                depth[g.gate_id] = 1 + max(depth[i] for i in g.inputs)
        levels: dict[int, list[int]] = {}
        for g in self.gates:
            if g.kind != INPUT:
                levels.setdefault(depth[g.gate_id], []).append(g.gate_id)
        return [levels[d] for d in sorted(levels)]

    def non_free_depth(self) -> int:
        """Depth counting only Mul/PubLut/SlotTransfer gates (non-free ops)."""
        costly = {MUL, PUB_LUT, SLOT_TRANSFER}
        depth = [0] * len(self.gates)
        for g in self.gates:
            base = max((depth[i] for i in g.inputs), default=0)
            depth[g.gate_id] = base + (1 if g.kind in costly else 0)
        return max((depth[o] for o in self.output_ids), default=0)

    # ---------------------------------------------------------------- eval

    def _resolve_payload(self, payload, bindings):
        """Resolve a param-sourced gate payload against call bindings."""
        if isinstance(payload, tuple) and len(payload) == 2 and payload[0] == _PARAM:
            return bindings[payload[1]]
        return payload

    def _gate_dispatch(self, g, wires, params, one, plt_evaluator,
                       slot_transfer_evaluator, param_bindings,
                       call_cache, summed_cache, eval_sub):
        """Evaluate one non-Input gate against resolved input wires."""
        ins = [wires[i] for i in g.inputs]
        if g.kind == ADD:
            return ins[0] + ins[1]
        if g.kind == SUB:
            return ins[0] - ins[1]
        if g.kind == MUL:
            return ins[0] * ins[1]
        if g.kind == SMALL_SCALAR_MUL:
            scalar = self._resolve_payload(g.payload, param_bindings)
            return ins[0].small_scalar_mul(params, list(scalar))
        if g.kind == LARGE_SCALAR_MUL:
            scalar = self._resolve_payload(g.payload, param_bindings)
            return ins[0].large_scalar_mul(params, list(scalar))
        if g.kind == PUB_LUT:
            assert plt_evaluator is not None, "PubLut gate requires a plt_evaluator"
            lut = self.luts[g.payload]
            return plt_evaluator.public_lookup(params, lut, one, ins[0], g.gate_id, g.payload)
        if g.kind == SLOT_TRANSFER:
            assert slot_transfer_evaluator is not None, (
                "SlotTransfer gate requires a slot_transfer_evaluator"
            )
            spec = self._resolve_payload(g.payload, param_bindings)
            return slot_transfer_evaluator.slot_transfer(
                params, ins[0], spec.materialize(), g.gate_id
            )
        if g.kind == SLOT_REDUCE:
            assert slot_transfer_evaluator is not None, (
                "SlotReduce gate requires a slot_transfer_evaluator"
            )
            return slot_transfer_evaluator.slot_reduce(params, ins, g.payload, g.gate_id)
        if g.kind == SUB_CIRCUIT_OUTPUT:
            call_id, out_idx = g.payload
            if call_id not in call_cache:
                call = self.sub_circuit_calls[call_id]
                call_cache[call_id] = eval_sub(call.sub_circuit_id, ins, call.param_bindings)
            return call_cache[call_id][out_idx]
        if g.kind == SUMMED_SUB_CIRCUIT_OUTPUT:
            summed_id, out_idx = g.payload
            if summed_id not in summed_cache:
                call = self.summed_sub_circuit_calls[summed_id]
                acc = None
                off = 0
                for set_idx, inp_set in enumerate(call.call_inputs):
                    sub_ins = ins[off : off + len(inp_set)]
                    off += len(inp_set)
                    outs = eval_sub(
                        call.sub_circuit_id, sub_ins, call.param_bindings[set_idx]
                    )
                    acc = outs if acc is None else [a + b for a, b in zip(acc, outs)]
                summed_cache[summed_id] = acc
            return summed_cache[summed_id][out_idx]
        raise NotImplementedError(f"gate kind {g.kind}")

    def eval(
        self,
        params,
        one,
        inputs: list,
        plt_evaluator=None,
        slot_transfer_evaluator=None,
        param_bindings: tuple = (),
        batched: bool = False,
    ) -> list:
        """Evaluate the circuit over wires of any Evaluable-like type.

        `one` feeds wire 0 (the reserved constant-one input); `inputs` feed
        the user Input gates in order. Gates are
        evaluated in topological (id) order, wires freed by use count; sub-
        circuit calls recurse with their bound parameters (subcircuits.rs).

        `batched=True` switches to the level-grouped batched evaluator
        (batched_eval.py) — bit-identical results, same-kind gates per level
        collapsed into single device programs.
        """
        assert len(inputs) == self.num_input, (
            f"expected {self.num_input} inputs, got {len(inputs)}"
        )
        if batched:
            from .batched_eval import eval_batched

            return eval_batched(
                self, params, one, inputs, plt_evaluator,
                slot_transfer_evaluator, param_bindings,
            )
        uses = self.use_counts()
        wires: dict[int, Any] = {0: one}
        for i, v in enumerate(inputs):
            wires[i + 1] = v
        remaining = list(uses)
        call_cache: dict[int, list] = {}
        summed_cache: dict[int, list] = {}
        out_set = set(self.output_ids)

        def consume(i: int):
            remaining[i] -= 1
            if remaining[i] == 0 and i not in out_set:
                wires.pop(i, None)

        def eval_sub(circuit_id, sub_inputs, bindings):
            sub = self.sub_circuits[circuit_id]
            return sub.eval(
                params,
                one,
                sub_inputs,
                plt_evaluator,
                slot_transfer_evaluator,
                param_bindings=bindings,
            )

        for g in self.gates:
            if g.kind == INPUT:
                continue
            out = self._gate_dispatch(
                g, wires, params, one, plt_evaluator, slot_transfer_evaluator,
                param_bindings, call_cache, summed_cache, eval_sub,
            )
            for i in g.inputs:
                consume(i)
            wires[g.gate_id] = out

        return [wires[o] for o in self.output_ids]
