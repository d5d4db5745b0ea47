"""Mask-decrypt circuits shared by masked decoders.

A copy of `mxx_tpu/decoder/mask_circuit.py`, after the reference's src/decoder/mask_circuit.rs: derives per-bit
plaintext moduli for bit-decomposed masks (bit j decrypts with modulus
q / 2^j so the Ring-GSW q/t scaling contributes the 2^j weight), and builds
split GSW decrypt circuits whose (secret_dependent, public_bottom) pairs feed
the masked high-bit decoder and noise refresh.
"""

from __future__ import annotations

from ..circuit import PolyCircuit
from ..gadgets.fhe.ring_gsw import RingGswCiphertext


def mask_plaintext_moduli_from_full_modulus(full_modulus: int, bit_size: int) -> list[int]:
    assert bit_size > 0 and full_modulus > 0
    out = []
    for bit_idx in range(bit_size):
        m = full_modulus >> bit_idx
        assert m > 0
        out.append(m)
    return out


def decrypt_error_as_value(circuit: PolyCircuit, encrypted: RingGswCiphertext,
                           key_wire: int, plaintext_modulus: int) -> int:
    """Decrypt one error ciphertext to a single wire (mask_circuit.rs:
    decrypt_error_coefficients_as_polynomial, scalar-ring case)."""
    sd, pb = encrypted.decrypt(circuit, key_wire, plaintext_modulus)
    return circuit.add_gate(sd, pb)


def decrypt_bit_decomposed_parts(circuit: PolyCircuit,
                                 encrypted_bits: list[RingGswCiphertext],
                                 key_wire: int,
                                 plaintext_moduli: list[int]) -> tuple[int, int]:
    """Split decrypt of a bit-decomposed mask: sums the per-bit
    (secret_dependent, public_bottom) branches separately
    (mask_circuit.rs:125-170)."""
    assert len(encrypted_bits) == len(plaintext_moduli) and encrypted_bits
    sds, pbs = [], []
    for ct, t in zip(encrypted_bits, plaintext_moduli):
        sd, pb = ct.decrypt(circuit, key_wire, t)
        sds.append(sd)
        pbs.append(pb)
    sd = sds[0]
    for w in sds[1:]:
        sd = circuit.add_gate(sd, w)
    pb = pbs[0]
    for w in pbs[1:]:
        pb = circuit.add_gate(pb, w)
    return sd, pb


def decrypt_centered_bit_decomposed(circuit: PolyCircuit, params,
                                    encrypted_bits: list[RingGswCiphertext],
                                    key_wire: int,
                                    plaintext_moduli: list[int]) -> int:
    """Centered decode: decrypted mask plus the 2^{bits-1} midpoint
    (mask_circuit.rs:173-199)."""
    sd, pb = decrypt_bit_decomposed_parts(circuit, encrypted_bits, key_wire, plaintext_moduli)
    total = circuit.add_gate(sd, pb)
    midpoint = 1 << (len(plaintext_moduli) - 1)
    mid = circuit.const_coeffs([midpoint] + [0] * (params.n - 1))
    return circuit.add_gate(total, mid)


def center_public_bottom(circuit: PolyCircuit, params, public_bottom: int,
                         mask_bits: int) -> int:
    midpoint = 1 << (mask_bits - 1)
    mid = circuit.const_coeffs([midpoint] + [0] * (params.n - 1))
    return circuit.sub_gate(public_bottom, mid)
