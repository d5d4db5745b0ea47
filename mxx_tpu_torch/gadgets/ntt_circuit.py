"""In-circuit radix-2 negacyclic NTT over packed slots: a copy of
`mxx_tpu/gadgets/ntt_circuit.py` (host code that builds gates).

The butterfly network is expressed as explicit slot-transfer gates
(per-destination source slot + twiddle scalar) followed by adds and
LUT-based mod-p reduction, the circuit analog of the ring NTT
(`ring/ntt.py`), sharing its merged-psi bit-reversed convention.

Slot values live mod a small prime p (p = 1 mod 2N); each stage applies
    out[j]   = x[j] + psi_w * x[j + t]
    out[j+t] = x[j] + (p - psi_w) * x[j + t]
with the subtraction realized through the (p - w) twiddle so values stay
non-negative, then reduces every slot with the mod-p LUT.
"""

from __future__ import annotations

from ..circuit import PolyCircuit
from ..lookup import PublicLut
from ..ring.element import FinRingElem
from ..utils import numth


def _bit_rev_psi_table(p: int, n: int, inverse: bool) -> list[int]:
    psi = numth.find_primitive_2n_root(p, n)
    if inverse:
        psi = numth.modinv(psi, p)
    ln = n.bit_length() - 1
    return [pow(psi, numth.bit_reverse(i, ln), p) for i in range(n)]


def register_mod_p_lut(circuit: PolyCircuit, params, p: int, domain: int) -> int:
    q = params.modulus
    return circuit.register_public_lut(
        PublicLut(
            params,
            domain,
            lambda _p, t, p_=p, d=domain: (t, FinRingElem(t % p_, q)) if t < d else None,
            max_output_row=(0, FinRingElem(0, q)),
        )
    )


def forward_ntt(circuit: PolyCircuit, wire: int, num_slots: int, p: int,
                lut_mod_p: int) -> int:
    """Negacyclic NTT mod p over `num_slots` packed slots (natural ->
    bit-reversed eval order, matching ring/ntt.ntt_fwd)."""
    n = num_slots
    psi_rev = _bit_rev_psi_table(p, n, inverse=False)
    x = wire
    m, t = 1, n
    while m < n:
        t //= 2
        # left operand: out[slot] = x[pair_base(slot)]
        left_spec, right_spec = [], []
        for slot in range(n):
            blk, off = divmod(slot, 2 * t)
            j = blk * 2 * t + (off % t)
            w = psi_rev[m + blk]
            scalar = w if off < t else p - w
            left_spec.append((j, None))
            right_spec.append((j + t, scalar))
        a = circuit.slot_transfer_gate(x, left_spec)
        wb = circuit.slot_transfer_gate(x, right_spec)
        s = circuit.add_gate(a, wb)
        x = circuit.public_lookup_gate(s, lut_mod_p)
        m *= 2
    return x


def inverse_ntt(circuit: PolyCircuit, wire: int, num_slots: int, p: int,
                lut_mod_p: int) -> int:
    """Inverse transform (bit-reversed -> natural order) with final n^{-1}."""
    n = num_slots
    psi_inv_rev = _bit_rev_psi_table(p, n, inverse=True)
    x = wire
    t, m = 1, n
    while m > 1:
        h = m // 2
        u_spec, w_spec = [], []
        for slot in range(n):
            blk, off = divmod(slot, 2 * t)
            j = blk * 2 * t + (off % t)
            tw = psi_inv_rev[h + blk]
            if off < t:
                # out = x[j] + x[j+t]
                u_spec.append((j, None))
                w_spec.append((j + t, None))
            else:
                # out = tw * x[j] + (p - tw) * x[j+t]
                u_spec.append((j, tw))
                w_spec.append((j + t, p - tw))
        a = circuit.slot_transfer_gate(x, u_spec)
        b = circuit.slot_transfer_gate(x, w_spec)
        s = circuit.add_gate(a, b)
        x = circuit.public_lookup_gate(s, lut_mod_p)
        t *= 2
        m = h
    n_inv = numth.modinv(n, p)
    x = circuit.small_scalar_mul(x, [n_inv])
    return circuit.public_lookup_gate(x, lut_mod_p)
