"""JSON circuit interchange: a copy of `mxx_tpu/circuit/serde.py`, so a
circuit saved by either package loads in the other and the JSON of the same
circuit is equal string for string. The schema is that of the reference's
`SerializablePolyCircuit`, in serde_json's conventions for its Rust types:
- unit enum variants -> strings ("Add", "Input", ...)
- data variants -> single-key objects ({"PubLut": {"lut_id": 3}})
- GateParamSource -> {"Const": value} | {"Param": id}
- BigUint -> little-endian u32 digit list (num-bigint serde format)
- BatchedWire -> {"start": gid, "end": gid} (end exclusive)

LUT contents are NOT serialized: gates keep only `lut_id`, and the tables
are registered again after a load.
"""

from __future__ import annotations

import json

from .circuit import (
    PolyCircuit,
    SubCircuitCall,
    SummedSubCircuitCall,
    _PARAM,
)
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


def _biguint_to_digits(v: int) -> list[int]:
    digits = []
    while v:
        digits.append(v & 0xFFFFFFFF)
        v >>= 32
    return digits


def _digits_to_biguint(digits: list[int]) -> int:
    v = 0
    for d in reversed(digits):
        v = (v << 32) | d
    return v


def _spec_to_json(spec: SlotTransferSpec):
    if spec.kind == "explicit":
        return {"Explicit": [[s, sc] for s, sc in spec.values]}
    if spec.kind == "rotation":
        return {"Rotation": {"diagonal": spec.diagonal, "num_slots": spec.num_slots}}
    return {
        "Repeated": {
            "src_slot": spec.src_slot,
            "num_slots": spec.num_slots,
            "prefix_len": spec.prefix_len,
            "prefix_scalar": spec.prefix_scalar,
        }
    }


def _spec_from_json(obj) -> SlotTransferSpec:
    if "Explicit" in obj:
        return SlotTransferSpec.explicit([(s, sc) for s, sc in obj["Explicit"]])
    if "Rotation" in obj:
        r = obj["Rotation"]
        return SlotTransferSpec.rotation(r["diagonal"], r["num_slots"])
    r = obj["Repeated"]
    return SlotTransferSpec.repeated(
        r["src_slot"], r["num_slots"], r["prefix_len"], r.get("prefix_scalar")
    )


def _param_source(payload, encode_value):
    if isinstance(payload, tuple) and len(payload) == 2 and payload[0] == _PARAM:
        return {"Param": payload[1]}
    return {"Const": encode_value(payload)}


def _gate_type_to_json(circuit: PolyCircuit, g: Gate):
    if g.kind in (INPUT, ADD, SUB, MUL):
        return g.kind
    if g.kind == SMALL_SCALAR_MUL:
        return {"SmallScalarMul": {"scalar": _param_source(g.payload, list)}}
    if g.kind == LARGE_SCALAR_MUL:
        return {
            "LargeScalarMul": {
                "scalar": _param_source(
                    g.payload, lambda p: [_biguint_to_digits(int(v)) for v in p]
                )
            }
        }
    if g.kind == SLOT_TRANSFER:
        return {"SlotTransfer": {"src_slots": _param_source(g.payload, _spec_to_json)}}
    if g.kind == SLOT_REDUCE:
        return {"SlotReduce": {"num_slots": g.payload, "input_count": len(g.inputs)}}
    if g.kind == PUB_LUT:
        return {"PubLut": {"lut_id": g.payload}}
    if g.kind == SUB_CIRCUIT_OUTPUT:
        call_id, out_idx = g.payload
        return {
            "SubCircuitOutput": {
                "call_id": call_id,
                "output_idx": out_idx,
                "num_inputs": len(g.inputs),
            }
        }
    if g.kind == SUMMED_SUB_CIRCUIT_OUTPUT:
        summed_id, out_idx = g.payload
        return {
            "SummedSubCircuitOutput": {
                "summed_call_id": summed_id,
                "output_idx": out_idx,
                "num_inputs": len(g.inputs),
            }
        }
    raise NotImplementedError(g.kind)


def _gate_from_json(obj) -> Gate:
    gid = obj["gate_id"]
    gt = obj["gate_type"]
    inputs = tuple(obj["input_gates"])
    if isinstance(gt, str):
        return Gate(gid, gt, inputs)
    ((variant, body),) = gt.items()
    if variant == "SmallScalarMul":
        src = body["scalar"]
        payload = (
            (_PARAM, src["Param"]) if "Param" in src else tuple(src["Const"])
        )
        return Gate(gid, SMALL_SCALAR_MUL, inputs, payload)
    if variant == "LargeScalarMul":
        src = body["scalar"]
        payload = (
            (_PARAM, src["Param"])
            if "Param" in src
            else tuple(_digits_to_biguint(d) for d in src["Const"])
        )
        return Gate(gid, LARGE_SCALAR_MUL, inputs, payload)
    if variant == "SlotTransfer":
        src = body["src_slots"]
        payload = (_PARAM, src["Param"]) if "Param" in src else _spec_from_json(src["Const"])
        return Gate(gid, SLOT_TRANSFER, inputs, payload)
    if variant == "SlotReduce":
        return Gate(gid, SLOT_REDUCE, inputs, body["num_slots"])
    if variant == "PubLut":
        return Gate(gid, PUB_LUT, inputs, body["lut_id"])
    if variant == "SubCircuitOutput":
        return Gate(gid, SUB_CIRCUIT_OUTPUT, inputs, (body["call_id"], body["output_idx"]))
    if variant == "SummedSubCircuitOutput":
        return Gate(
            gid, SUMMED_SUB_CIRCUIT_OUTPUT, inputs, (body["summed_call_id"], body["output_idx"])
        )
    raise NotImplementedError(variant)


def _wires_to_batched(ids) -> list[dict]:
    return [{"start": i, "end": i + 1} for i in ids]


def _batched_to_wires(batched) -> list[int]:
    out = []
    for b in batched:
        out.extend(range(b["start"], b["end"]))
    return out


def circuit_to_json_obj(circuit: PolyCircuit) -> dict:
    return {
        "gates": {
            str(g.gate_id): {
                "gate_id": g.gate_id,
                "gate_type": _gate_type_to_json(circuit, g),
                "input_gates": list(g.inputs),
            }
            for g in circuit.gates
        },
        "sub_circuits": {
            str(cid): circuit_to_json_obj(sub) for cid, sub in circuit.sub_circuits.items()
        },
        "sub_circuit_calls": {
            str(call_id): {
                "sub_circuit_id": call.sub_circuit_id,
                "shared_input_prefix": None,
                "input_suffix": _wires_to_batched(call.inputs),
                "param_bindings": [_binding_to_json(b) for b in call.param_bindings],
                "input_max_plaintext_norm_ranges": None,
                "scoped_call_id": call_id,
                "output_gate_ids": list(call.output_gate_ids),
                "num_outputs": len(call.output_gate_ids),
            }
            for call_id, call in circuit.sub_circuit_calls.items()
        },
        "summed_sub_circuit_calls": {
            str(sid): {
                "sub_circuit_id": call.sub_circuit_id,
                "call_inputs": [_wires_to_batched(s) for s in call.call_inputs],
                "param_bindings": [
                    [_binding_to_json(b) for b in pb] for pb in call.param_bindings
                ],
                "input_max_plaintext_norm_ranges": None,
                "scoped_call_ids": list(range(len(call.call_inputs))),
                "output_gate_ids": list(call.output_gate_ids),
                "num_outputs": len(call.output_gate_ids),
            }
            for sid, call in circuit.summed_sub_circuit_calls.items()
        },
        "sub_circuit_params": list(circuit.sub_circuit_params),
        "sub_circuit_input_max_plaintext_norm_ranges": None,
        "output_ids": list(circuit.output_ids),
        "num_input": circuit.num_input,
        "next_scoped_call_id": len(circuit.sub_circuit_calls),
    }


def _binding_to_json(b):
    if isinstance(b, SlotTransferSpec):
        return {"SlotTransfer": _spec_to_json(b)}
    vals = list(b)
    if all(0 <= int(v) < (1 << 32) for v in vals):
        return {"SmallScalarMul": [int(v) for v in vals]}
    return {"LargeScalarMul": [_biguint_to_digits(int(v)) for v in vals]}


def _binding_from_json(obj):
    if "SlotTransfer" in obj:
        return _spec_from_json(obj["SlotTransfer"])
    if "SmallScalarMul" in obj:
        return tuple(obj["SmallScalarMul"])
    return tuple(_digits_to_biguint(d) for d in obj["LargeScalarMul"])


def circuit_from_json_obj(obj: dict) -> PolyCircuit:
    circuit = PolyCircuit.__new__(PolyCircuit)
    parsed = [_gate_from_json(gobj) for gobj in obj["gates"].values()]
    # Size by max gate id, not dict length: reference files may have sparse ids.
    gates = [None] * (1 + max((g.gate_id for g in parsed), default=-1))
    for g in parsed:
        gates[g.gate_id] = g
    circuit.gates = gates
    circuit.num_input = obj["num_input"]
    circuit.output_ids = list(obj["output_ids"])
    circuit.luts = {}
    circuit.sub_circuits = {
        int(cid): circuit_from_json_obj(sobj) for cid, sobj in obj["sub_circuits"].items()
    }
    for sub in circuit.sub_circuits.values():
        sub.luts = circuit.luts
    def _call_inputs(c):
        # The schema allows a shared input prefix reused across calls; calls
        # here hold a flat input list, so the prefix wires go before the
        # suffix.
        prefix = c.get("shared_input_prefix")
        wires = _batched_to_wires(prefix) if prefix else []
        return tuple(wires + _batched_to_wires(c["input_suffix"]))

    circuit.sub_circuit_calls = {
        int(cid): SubCircuitCall(
            c["sub_circuit_id"],
            _call_inputs(c),
            tuple(_binding_from_json(b) for b in c["param_bindings"]),
            list(c["output_gate_ids"]),
        )
        for cid, c in obj["sub_circuit_calls"].items()
    }
    circuit.summed_sub_circuit_calls = {
        int(sid): SummedSubCircuitCall(
            c["sub_circuit_id"],
            tuple(tuple(_batched_to_wires(s)) for s in c["call_inputs"]),
            tuple(tuple(_binding_from_json(b) for b in pb) for pb in c["param_bindings"]),
            list(c["output_gate_ids"]),
        )
        for sid, c in obj["summed_sub_circuit_calls"].items()
    }
    circuit.sub_circuit_params = list(obj["sub_circuit_params"])
    return circuit


def circuit_to_json(circuit: PolyCircuit) -> str:
    return json.dumps(circuit_to_json_obj(circuit))


def circuit_from_json(raw: str) -> PolyCircuit:
    return circuit_from_json_obj(json.loads(raw))


def save_circuit(circuit: PolyCircuit, path):
    with open(path, "w") as f:
        f.write(circuit_to_json(circuit))


def load_circuit(path) -> PolyCircuit:
    with open(path) as f:
        return circuit_from_json(f.read())
