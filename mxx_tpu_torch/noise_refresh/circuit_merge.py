"""Merge circuits for decoded noise-refresh material.

A copy of `mxx_tpu/noise_refresh/circuit_merge.py`, after the reference's src/noise_refresh/circuit_merge.rs: after GSW
decryption produced slotwise polynomial wires, the merge is plain circuit
addition. Keeping it separate lets tests and benchmarks feed pre-decoded
fixture wires without re-evaluating the expensive decrypt path.
"""

from __future__ import annotations

from ..circuit import PolyCircuit


def build_refreshed_wire_merge_subcircuit(value_count: int) -> PolyCircuit:
    """Inputs: value_count decoded errors then value_count decoded masks;
    output i = error_i + mask_i (circuit_merge.rs:17-33)."""
    assert value_count > 0
    circuit = PolyCircuit()
    wires = circuit.input(2 * value_count)
    errors, masks = wires[:value_count], wires[value_count:]
    circuit.output([circuit.add_gate(e, m) for e, m in zip(errors, masks)])
    return circuit


def build_refreshed_wire_digit_all_crt_merge(params) -> PolyCircuit:
    """All-CRT merge for one gadget digit: one decoded error + mask per CRT
    level (circuit_merge.rs:36-46)."""
    return build_refreshed_wire_merge_subcircuit(params.crt_depth)
