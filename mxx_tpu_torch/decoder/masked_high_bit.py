"""Masked high-bit decoder: preimage-backed decode cancellation + rounding.

A copy of `mxx_tpu/decoder/masked_high_bit.py`, after the reference's src/decoder/masked_high_bit.rs. The offline pass
stores, per decoder output, a trapdoor preimage of the projected public-key
target [A * G^{-1}(e_0) ; 0]; the online pass computes

    decoder_state * preimage - c * G^{-1}(e_0) + public_bottom

which cancels the secret-dependent part, leaving (q/p) * value + centered
mask, rounded with `decode_centered_masked_integer_coeff`. Every matrix the
decoder makes lies on the device of the matrix it was handed.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..matrix import PolyMatrix
from ..ring.poly import Poly


def decode_centered_masked_integer_coeff(coeff: int, q_modulus: int, plaintext_modulus: int) -> int:
    assert plaintext_modulus > 1
    half_q = q_modulus // 2
    return (plaintext_modulus * coeff + half_q) // q_modulus % plaintext_modulus


def decode_centered_masked_boolean_coeff(coeff: int, q_modulus: int) -> bool:
    return decode_centered_masked_integer_coeff(coeff, q_modulus, 2) == 1


def decode_centered_masked_matrix(params, noisy: PolyMatrix, plaintext_modulus: int) -> PolyMatrix:
    q = params.modulus
    rows = []
    for i in range(noisy.nrow):
        row = []
        for j in range(noisy.ncol):
            coeffs = noisy.entry(i, j).coeffs()
            row.append(
                Poly.from_int_coeffs(
                    params,
                    [
                        decode_centered_masked_integer_coeff(c, q, plaintext_modulus)
                        for c in coeffs
                    ],
                    noisy.data.device,
                )
            )
        rows.append(row)
    return PolyMatrix.from_polys(params, rows)


@dataclass
class MaskedHighBitEvaluatedOutput:
    secret_dependent: object  # BGGEncodingVec (or single BggEncoding list)
    public_bottom: object


@dataclass
class MaskedHighBitOnlineInput:
    decoder_state: PolyMatrix
    outputs: list[MaskedHighBitEvaluatedOutput]
    plaintext_moduli: list[int]


class MaskedHighBitDecoder:
    """Protocol-independent masked decoder; the protocol supplies the preimage
    sampler closure and artifact ids (masked_high_bit.rs:127-200)."""

    def __init__(self, params, secret_size: int, artifacts, preimage_sampler, artifact_id):
        self.params = params
        self.secret_size = secret_size
        self.artifacts = artifacts
        self.preimage_sampler = preimage_sampler
        self.artifact_id = artifact_id

    def identity_selector(self, device="cuda") -> PolyMatrix:
        return PolyMatrix.identity(self.params, self.secret_size, device=device).slice_columns(0, 1)

    def projected_public_key_target(self, public_key_matrix: PolyMatrix) -> PolyMatrix:
        device = public_key_matrix.data.device
        sel = self.identity_selector(device)
        top = public_key_matrix.mul_decompose(sel)
        bottom = PolyMatrix.zero(self.params, self.secret_size, top.ncol, device=device)
        return top.concat_rows([bottom])

    def preprocess_public_key_matrix(self, decoder_idx: int, public_key_matrix: PolyMatrix):
        target = self.projected_public_key_target(public_key_matrix)
        preimage = self.preimage_sampler(decoder_idx, target)
        self.artifacts.write_matrix(self.artifact_id(decoder_idx), preimage)

    def projected_decoder_output(self, decoder_state: PolyMatrix, decoder_idx: int) -> PolyMatrix:
        preimage = self.artifacts.read_matrix(
            self.params, self.artifact_id(decoder_idx), decoder_state.data.device
        )
        return decoder_state @ preimage

    def online_decode(self, inp: MaskedHighBitOnlineInput, initial_offset: int = 0):
        """Returns decoded coefficient lists per output (masked_high_bit.rs:
        online_decode_with_offset_...)."""
        sel = self.identity_selector(inp.decoder_state.data.device)
        decoded_all = []
        decoder_idx = initial_offset
        for output, p_mod in zip(inp.outputs, inp.plaintext_moduli):
            sd = output.secret_dependent
            pb = output.public_bottom
            sd_list = sd.encodings if hasattr(sd, "encodings") else sd
            pb_list = pb.encodings if hasattr(pb, "encodings") else pb
            rounded = []
            for enc, pub in zip(sd_list, pb_list):
                proj = self.projected_decoder_output(inp.decoder_state, decoder_idx)
                decoder_idx += 1
                pub_pt = pub.plaintext
                noisy = (
                    proj
                    - enc.vector.mul_decompose(sel)
                    + PolyMatrix.from_poly_row(self.params, [pub_pt])
                )
                mat = decode_centered_masked_matrix(self.params, noisy, p_mod)
                for i in range(mat.nrow):
                    for j in range(mat.ncol):
                        rounded.extend(mat.entry(i, j).coeffs())
            decoded_all.append(rounded)
        return decoded_all
