"""Slot-transfer evaluators for vector wire types.

A copy of `mxx_tpu/slot_transfer/evaluators.py` (reference:
src/slot_transfer/{mod.rs,poly_vec.rs,naive_vec.rs}). Semantics:
- slot_transfer(input, src_slots): out[dst] = input[src] * optional-scalar
  (the scalar is a small constant, applied as small_scalar_mul([scalar])).
- slot_reduce(inputs, num_slots): out[i] = sum_{s < num_slots}
  inputs[i][s] * x^s — packs each input vector's leading slots into a single
  polynomial wire via monomial shifts.

The preimage-backed packed-encoding variant (BggPolyEncodingSTEvaluator) is a
separate, later component; these vector evaluators are its ground truth.
"""

from __future__ import annotations

from ..bgg.vec import BGGEncodingVec, BGGPublicKeyVec
from ..circuit.poly_vec import PolyVec


def _slot_transfer_generic(ctor, slots, params, src_slots):
    out = []
    for src, scalar in src_slots:
        assert src < len(slots), f"source slot {src} out of range"
        sel = slots[src]
        out.append(sel if scalar is None else sel.small_scalar_mul(params, [scalar]))
    return ctor(out)


def _slot_reduce_generic(ctor, inputs_slots, params, num_slots, n):
    out = []
    for slots in inputs_slots:
        assert len(slots) >= num_slots
        acc = None
        for s in range(num_slots):
            scalar = [0] * n
            scalar[s] = 1
            term = slots[s].small_scalar_mul(params, scalar)
            acc = term if acc is None else acc + term
        out.append(acc)
    return ctor(out)


class PolyVecSlotTransferEvaluator:
    def slot_transfer(self, params, input_vec: PolyVec, src_slots, gate_id):
        assert len(src_slots) <= params.n
        return _slot_transfer_generic(PolyVec.new, input_vec.slots, params, src_slots)

    def slot_reduce(self, params, inputs: list[PolyVec], num_slots: int, gate_id):
        assert 0 < len(inputs) <= num_slots <= params.n
        return _slot_reduce_generic(
            PolyVec.new, [v.slots for v in inputs], params, num_slots, params.n
        )


class BGGVecSlotTransferEvaluator:
    """Works for both BGGPublicKeyVec and BGGEncodingVec wires."""

    def slot_transfer(self, params, input_vec, src_slots, gate_id):
        if isinstance(input_vec, BGGPublicKeyVec):
            return _slot_transfer_generic(BGGPublicKeyVec.new, input_vec.keys, params, src_slots)
        return _slot_transfer_generic(BGGEncodingVec.new, input_vec.encodings, params, src_slots)

    def slot_reduce(self, params, inputs, num_slots, gate_id):
        assert 0 < len(inputs) <= num_slots <= params.n
        if isinstance(inputs[0], BGGPublicKeyVec):
            return _slot_reduce_generic(
                BGGPublicKeyVec.new, [v.keys for v in inputs], params, num_slots, params.n
            )
        return _slot_reduce_generic(
            BGGEncodingVec.new, [v.encodings for v in inputs], params, num_slots, params.n
        )
