"""Ring-GSW decryption circuits for noise-refresh PRG material.

A copy of `mxx_tpu/noise_refresh/circuit_decrypt.py`, after the reference's src/noise_refresh/circuit_decrypt.rs: decode
ciphertext material into slotwise polynomial wires; the error+mask merge
lives in circuit_merge. Error coefficients decrypt through
`decrypt_error_coefficients_as_polynomial`; per-CRT mask bits through
`decrypt_centered_bit_decomposed_polynomial` (decoder/mask_circuit.rs).
"""

from __future__ import annotations

from ..circuit import PolyCircuit
from ..decoder.mask_circuit import mask_plaintext_moduli_from_full_modulus
from ..gadgets.fhe.ring_gsw import RingGswCiphertext


def decrypt_error_coefficients_as_polynomial(circuit: PolyCircuit,
                                             errors: list[RingGswCiphertext],
                                             key_wire: int,
                                             plaintext_modulus: int) -> int:
    """Decrypt ring_dim coefficient ciphertexts into one polynomial wire
    (mask_circuit.rs:42-76): batch-decrypt with monomial packing, then sum the
    split halves."""
    params = errors[0].ctx.params
    assert len(errors) <= params.n
    sd, pb = RingGswCiphertext.decrypt_batch(errors, circuit, key_wire, plaintext_modulus)
    return circuit.add_gate(sd, pb)


def decrypt_bit_decomposed_polynomial_parts(circuit: PolyCircuit,
                                            bits: list[RingGswCiphertext],
                                            key_wire: int,
                                            plaintext_moduli: list[int]):
    """Decrypt one bit-decomposed polynomial mask into split halves
    (mask_circuit.rs:123-169): chunk layout is coeff-major
    (bits[coeff * bit_size + bit])."""
    bit_size = len(plaintext_moduli)
    assert bit_size > 0
    params = bits[0].ctx.params
    # coefficient count from the chunk: ring_dim at full scale, fewer for the
    # debug_reuse_single_material shapes (the remaining coefficients decode 0)
    n_coeffs = len(bits) // bit_size
    assert 0 < n_coeffs <= params.n and n_coeffs * bit_size == len(bits), (
        "chunk must be n_coeffs * bit_size with n_coeffs <= ring_dim"
    )
    sd_acc = None
    pb_acc = None
    for bit_idx, t in enumerate(plaintext_moduli):
        cts = [bits[coeff * bit_size + bit_idx] for coeff in range(n_coeffs)]
        sd, pb = RingGswCiphertext.decrypt_batch(cts, circuit, key_wire, t)
        sd_acc = sd if sd_acc is None else circuit.add_gate(sd_acc, sd)
        pb_acc = pb if pb_acc is None else circuit.add_gate(pb_acc, pb)
    return sd_acc, pb_acc


def decrypt_centered_bit_decomposed_polynomial(circuit: PolyCircuit,
                                               bits: list[RingGswCiphertext],
                                               key_wire: int,
                                               plaintext_moduli: list[int]) -> int:
    """Split-decrypt + recenter with the 2^{bits-1} midpoint at every
    coefficient (mask_circuit.rs:172-199; same convention as the scalar
    decoder/mask_circuit.decrypt_centered_bit_decomposed)."""
    sd, pb = decrypt_bit_decomposed_polynomial_parts(circuit, bits, key_wire, plaintext_moduli)
    params = bits[0].ctx.params
    total = circuit.add_gate(sd, pb)
    midpoint = 1 << (len(plaintext_moduli) - 1)
    mid = circuit.const_coeffs([midpoint] * params.n)
    return circuit.add_gate(total, mid)


def build_refreshed_wire_crt_decrypt_subcircuit(ring_gsw_ctx, v_bits: int,
                                                errors_count: int):
    """One CRT-level decrypt circuit for one refreshed wire
    (circuit_decrypt.rs:57+): inputs = key wire, error ciphertext wires, mask
    ciphertext wires for one CRT level; outputs = (decoded_error,
    decoded_mask)."""
    from ..gadgets.fhe.ring_gsw import RingGswCiphertext as Ct

    circuit = PolyCircuit()
    key = circuit.input(1)[0]
    params = ring_gsw_ctx.params
    moduli = mask_plaintext_moduli_from_full_modulus(ring_gsw_ctx.q_big, v_bits)
    errors = [Ct.input(ring_gsw_ctx, circuit, 1) for _ in range(errors_count)]
    masks = [
        Ct.input(ring_gsw_ctx, circuit, 1) for _ in range(params.n * v_bits)
    ]
    decoded_error = decrypt_error_coefficients_as_polynomial(
        circuit, errors, key, ring_gsw_ctx.q_big
    )
    decoded_mask = decrypt_centered_bit_decomposed_polynomial(
        circuit, masks, key, moduli
    )
    circuit.output([decoded_error, decoded_mask])
    return circuit
