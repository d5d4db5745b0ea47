"""Negacyclic convolution gadget over slot-packed wires (NTT-free).

A copy of `mxx_tpu/gadgets/conv_mul.py`, after the reference's src/gadgets/conv_mul/mod.rs: for packed wires
a, b carrying N slot values, computes c = a * b in Z[X]/(X^N + 1) via

- signed diagonals diag_d[i] = a_d (i >= d), -a_d (i < d), built as
  3*rep - 2*rep_prefix2 from two Repeated slot transfers (the reference's
  "a_d - 2 * wrap_prefix(a_d)" trick with small scalars only);
- rotated views rot_d[i] = b[(i - d) mod N] via Rotation slot transfers;
- pointwise products and a balanced reduction tree.

Works over any Evaluable with a slot-transfer evaluator (PolyVec ground
truth, BGG vectors, nested-RNS packed wires).
"""

from __future__ import annotations

from ..circuit import PolyCircuit, SlotTransferSpec


def negacyclic_conv_mul(circuit: PolyCircuit, a_wire: int, b_wire: int, num_slots: int) -> int:
    terms = []
    for d in range(num_slots):
        rep = circuit.slot_transfer_gate_spec(
            a_wire, SlotTransferSpec.repeated(d, num_slots, 0, None)
        )
        if d == 0:
            diag = rep
        else:
            rep2 = circuit.slot_transfer_gate_spec(
                a_wire, SlotTransferSpec.repeated(d, num_slots, d, 2)
            )
            three_rep = circuit.small_scalar_mul(rep, [3])
            two_rep2 = circuit.small_scalar_mul(rep2, [2])
            diag = circuit.sub_gate(three_rep, two_rep2)
        rot = circuit.slot_transfer_gate_spec(
            b_wire, SlotTransferSpec.rotation(d, num_slots)
        )
        terms.append(circuit.mul_gate(diag, rot))
    # balanced reduction tree
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            nxt.append(circuit.add_gate(terms[i], terms[i + 1]))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def negacyclic_conv_mul_plaintext(circuit: PolyCircuit, a_wire: int,
                                  b_coeffs: list[int], num_slots: int,
                                  p: int, lut_mod_p: int | None = None) -> int:
    """Negacyclic convolution with a PUBLIC polynomial b mod p: one
    slot-transfer gate per nonzero b_d (per-destination source slot + the
    sign-folded scalar b_d / p - b_d), an add tree, and one optional mod-p
    LUT reduction — no wire-by-wire Mul gates at all (the public-operand
    sibling of `negacyclic_conv_mul`; the reference reaches the same
    savings via `negacyclic_conv_mul_right_sparse`)."""
    terms = []
    for d, bd in enumerate(b_coeffs):
        bd %= p
        if bd == 0:
            continue
        spec = []
        for i in range(num_slots):
            src = (i - d) % num_slots
            scalar = bd if i >= d else (p - bd) % p
            spec.append((src, scalar))
        terms.append(circuit.slot_transfer_gate(a_wire, spec))
    if not terms:
        z = circuit.sub_gate(a_wire, a_wire)
        return z
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            nxt.append(circuit.add_gate(terms[i], terms[i + 1]))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    out = terms[0]
    if lut_mod_p is not None:
        out = circuit.public_lookup_gate(out, lut_mod_p)
    return out
