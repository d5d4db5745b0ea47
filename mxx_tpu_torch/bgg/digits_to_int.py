"""Recompose base-digit wires into an integer wire.

A copy of `mxx_tpu/bgg/digits_to_int.py` (reference: src/bgg/digits_to_int.rs). For plain polys this is
sum_i digits[i] * b^i; for BGG pubkey/encoding wires each digit is projected
by mul_decompose with a scaled unit column (b^i at the last row), yielding
d x 1 projected wires that sum to the integer projection used by decoders.
The scalars are made on the device of the wire they multiply.
"""

from __future__ import annotations

from ..matrix import PolyMatrix
from ..ring.poly import Poly
from .encoding import BggEncoding
from .public_key import BggPublicKey


def power_of_base(wire, params, k: int):
    if isinstance(wire, Poly):
        return wire * Poly.from_power_of_base_to_constant(params, k, wire.data.device)
    if isinstance(wire, BggPublicKey):
        pk, enc = wire, None
    elif isinstance(wire, BggEncoding):
        pk, enc = wire.pubkey, wire
    else:
        raise TypeError(type(wire))
    d1 = pk.matrix.nrow
    scalar = Poly.from_power_of_base_to_constant(params, k, pk.matrix.data.device)
    unit = PolyMatrix.scaled_unit_column_vector(params, d1, d1 - 1, scalar)
    out_pk = BggPublicKey(pk.matrix.mul_decompose(unit), pk.reveal_plaintext)
    if enc is None:
        return out_pk
    return BggEncoding(
        enc.vector.mul_decompose(unit),
        out_pk,
        enc.plaintext * scalar if enc.plaintext is not None else None,
    )


def digits_to_int(digits: list, params):
    assert len(digits) == params.modulus_digits
    acc = None
    for i, digit in enumerate(digits):
        term = power_of_base(digit, params, i)
        acc = term if acc is None else acc + term
    return acc
