"""Vector-wire LUT evaluators: slotwise plaintext + slotwise LWE wrappers.

A copy of `mxx_tpu/lookup/vec_eval.py` (reference: src/lookup/{poly_vec.rs,
lwe/naive_vec.rs}). `SlotwisePltEvaluator` also has a `public_lookup_batch`,
so the level-batched evaluator takes a level's LUT gates over vec wires as
one batch of (gate, slot) lookups of the scalar evaluator, with the same
results as the per-slot loop.
"""

from __future__ import annotations

import inspect

from ..bgg.vec import BGGEncodingVec, BGGPublicKeyVec
from ..circuit.poly_vec import PolyVec
from ..ring.poly import Poly
from .lwe import LWEBGGEncodingPltEvaluator, LWEBGGPubKeyPltEvaluator


class PolyVecPltEvaluator:
    def public_lookup(self, params, plt, one, input_vec: PolyVec, gate_id, lut_id):
        out = []
        for p in input_vec.slots:
            x = p.const_value()
            got = plt.get(params, int(x))
            if got is None:
                raise KeyError(f"{x} not in LUT {lut_id} (gate {gate_id})")
            out.append(Poly.from_elem_to_constant(params, got[1], p.data.device))
        return PolyVec.new(out)


class LWEBGGVecPubKeyPltEvaluator:
    """Slotwise offline LWE evaluator over BGGPublicKeyVec wires."""

    def __init__(self, scalar: LWEBGGPubKeyPltEvaluator):
        self.scalar = scalar

    def public_lookup(self, params, plt, one, input_vec: BGGPublicKeyVec, gate_id, lut_id):
        keys = [
            self.scalar.public_lookup(params, plt, None, pk, gate_id, lut_id, slot_idx=s)
            for s, pk in enumerate(input_vec.keys)
        ]
        return BGGPublicKeyVec.new(keys)

    def sample_aux_matrices(self, params):
        self.scalar.sample_aux_matrices(params)


class LWEBGGVecEncodingPltEvaluator:
    """Slotwise online LWE evaluator over BGGEncodingVec wires."""

    def __init__(self, scalar: LWEBGGEncodingPltEvaluator):
        self.scalar = scalar

    def public_lookup(self, params, plt, one, input_vec: BGGEncodingVec, gate_id, lut_id):
        encs = [
            self.scalar.public_lookup(params, plt, None, e, gate_id, lut_id, slot_idx=s)
            for s, e in enumerate(input_vec.encodings)
        ]
        return BGGEncodingVec.new(encs)


def _slots(vec):
    return vec.keys if isinstance(vec, BGGPublicKeyVec) else vec.encodings


class SlotwisePltEvaluator:
    """Generic slotwise lift of any scalar PltEvaluator onto BGG vec wires
    (reference naive_vec evaluators' pattern, lwe/naive_vec.rs:14-143)."""

    def __init__(self, scalar):
        self.scalar = scalar
        # storage-backed evaluators key artifacts per slot; oracle evaluators
        # take no slot_idx — probe the signature once
        try:
            self._pass_slot = "slot_idx" in inspect.signature(
                scalar.public_lookup
            ).parameters
        except (TypeError, ValueError):
            self._pass_slot = False
        if not hasattr(scalar, "public_lookup_batch"):
            # no batch form to lift: the batched evaluator then looks up gate by gate
            self.public_lookup_batch = None

    def _slot_lookup(self, params, plt, wire, gate_id, lut_id, slot):
        if self._pass_slot:
            return self.scalar.public_lookup(
                params, plt, None, wire, gate_id, lut_id, slot_idx=slot
            )
        return self.scalar.public_lookup(params, plt, None, wire, gate_id, lut_id)

    def public_lookup(self, params, plt, one, input_vec, gate_id, lut_id):
        if isinstance(input_vec, BGGPublicKeyVec):
            return BGGPublicKeyVec.new([
                self._slot_lookup(params, plt, pk, gate_id, lut_id, s)
                for s, pk in enumerate(input_vec.keys)
            ])
        assert isinstance(input_vec, BGGEncodingVec), type(input_vec)
        return BGGEncodingVec.new([
            self._slot_lookup(params, plt, e, gate_id, lut_id, s)
            for s, e in enumerate(input_vec.encodings)
        ])

    def public_lookup_batch(self, params, items) -> list:
        """items = [(plt, input_vec, gate_id, lut_id)] over vec wires of one
        type: every (gate, slot) lookup in one call of the scalar
        evaluator's batch method; equal to per-gate `public_lookup`."""
        flat = []
        slot_idxs = []
        counts = []
        for plt, vec, gate_id, lut_id in items:
            slots = _slots(vec)
            counts.append(len(slots))
            for s, w in enumerate(slots):
                flat.append((plt, w, gate_id, lut_id))
                slot_idxs.append(s)
        if self._pass_slot:
            outs = self.scalar.public_lookup_batch(params, flat, slot_idxs=slot_idxs)
        else:
            outs = self.scalar.public_lookup_batch(params, flat)
        ctor = BGGPublicKeyVec.new if isinstance(items[0][1], BGGPublicKeyVec) else BGGEncodingVec.new
        res = []
        pos = 0
        for c in counts:
            res.append(ctor(outs[pos : pos + c]))
            pos += c
        return res

    def sample_aux_matrices(self, params):
        if hasattr(self.scalar, "sample_aux_matrices"):
            self.scalar.sample_aux_matrices(params)
