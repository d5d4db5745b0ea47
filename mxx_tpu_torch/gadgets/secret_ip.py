"""Inner product of public x secret wire vectors, the public operand kept on
the left to preserve BGG mul semantics (a copy of `mxx_tpu/gadgets/secret_ip.py`)."""

from __future__ import annotations

from ..circuit import PolyCircuit


def secret_inner_product(
    circuit: PolyCircuit, public_vec: list[int], secret_vec: list[int]
) -> int:
    assert len(public_vec) == len(secret_vec), "vector lengths must match"
    if not public_vec:
        return circuit.const_zero_gate()
    acc = circuit.mul_gate(public_vec[0], secret_vec[0])
    for pub_id, sec_id in zip(public_vec[1:], secret_vec[1:]):
        acc = circuit.add_gate(acc, circuit.mul_gate(pub_id, sec_id))
    return acc
