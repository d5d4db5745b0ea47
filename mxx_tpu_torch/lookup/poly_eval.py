"""Plaintext-level LUT evaluator, the ground truth of the circuit oracles:
the port's counterpart of `mxx_tpu/lookup/poly_eval.py`. It looks up the
constant coefficient of the input polynomial and returns the constant
polynomial y_k, on the input's device."""

from __future__ import annotations

from ..ring.poly import Poly


class PolyPltEvaluator:
    def public_lookup(self, params, plt, one: Poly, input_poly: Poly, gate_id: int, lut_id: int):
        x = input_poly.const_value()
        out = plt.get(params, int(x))
        if out is None:
            raise KeyError(
                f"lookup output not found; gate_id={gate_id} lut_id={lut_id} input={x}"
            )
        return Poly.from_elem_to_constant(params, out[1], input_poly.data.device)
