"""Diamond witness encryption (the port's counterpart of
`mxx_tpu/we/diamond_we.py`, with the same artifact files and hash tags).

Encryption embeds the message as the injector payload k = (q/2)*msg,
evaluates the relation circuit over hash-derived BGG pubkeys, and publishes
projection preimages plus the masked decoder preimage for
    A_dec = A_k + (A_1 - A_out) * G^{-1}(r),      r = Hash(tag ":r").
Decryption threads the witness digits through the injector, rebuilds the
one/k/witness encodings, evaluates the circuit over encodings, and computes
    noisy = state0 * decoder_preimage - (c_k + (c_1 - c_out) G^{-1}(r))
          = -k + (1 - y) * sigma * r,
which decodes the message iff the circuit output y == 1. Everything runs on
the injector's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from ..bgg import BGGPublicKeySampler, BggEncoding, BggPublicKey
from ..input_injector import DiamondInjector, DiamondInjectorPreprocessOut
from ..input_injector.diamond import DIAMOND_SECRET_SIZE
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import FinRingDist, HashSampler, TrapdoorSampler


@dataclass
class DiamondWECiphertext:
    circuit: object
    instance: list[bool]
    hash_key: bytes
    preprocess_out: DiamondInjectorPreprocessOut


class DiamondWE:
    def __init__(self, injector: DiamondInjector, witness_size: int, artifact_dir,
                 bgg_tag: bytes, seed: int | None = None):
        self.injector = injector
        self.witness_size = witness_size
        self.artifact_dir = Path(artifact_dir)
        self.bgg_tag = bgg_tag
        self.device = injector.device
        self._seed = seed
        # the injector's seed stream again, as in the JAX package
        self._trap = TrapdoorSampler(injector.params, injector.trapdoor_sigma, seed=seed,
                                     device=self.device)

    # ---------------------------------------------------------------- utils

    def _write(self, mid: str, m: PolyMatrix):
        (self.artifact_dir / f"diamond_we_{mid}.matrixbin").write_bytes(m.to_compact_bytes())

    def _read(self, mid: str) -> PolyMatrix:
        return PolyMatrix.from_compact_bytes(
            self.injector.params,
            (self.artifact_dir / f"diamond_we_{mid}.matrixbin").read_bytes(),
            self.device,
        )

    def _sample_bgg_public_keys(self, hash_key: bytes):
        params = self.injector.params
        sampler = BGGPublicKeySampler(hash_key, DIAMOND_SECRET_SIZE, self.device)
        pubkeys = sampler.sample(params, self.bgg_tag, [True] * self.witness_size)
        one_pubkey, witness_pubkeys = pubkeys[0], pubkeys[1:]
        k_matrix = HashSampler(self.device).sample_hash(
            params, hash_key, self.bgg_tag + b":k", DIAMOND_SECRET_SIZE,
            DIAMOND_SECRET_SIZE, FinRingDist(),
        )
        return one_pubkey, BggPublicKey(k_matrix, False), witness_pubkeys

    def _sample_r(self, hash_key: bytes) -> PolyMatrix:
        return HashSampler(self.device).sample_hash(
            self.injector.params, hash_key, self.bgg_tag + b":r", 1, 1, FinRingDist()
        )

    def _instance_wires(self, one, instance):
        return [one.small_scalar_mul(self.injector.params, [int(b)]) for b in instance]

    def _pack_witness_digits(self, witness: list[bool]) -> list[int]:
        bb = self.injector.batch_bits
        if len(witness) != self.witness_size or self.witness_size % bb:
            raise ValueError(f"witness of {len(witness)} bits: expected {self.witness_size}, "
                             f"a multiple of batch_bits {bb}")
        return [
            sum(int(witness[i * bb + b]) << b for b in range(bb))
            for i in range(self.witness_size // bb)
        ]

    def _zero(self, nrow: int, ncol: int) -> PolyMatrix:
        return PolyMatrix.zero(self.injector.params, nrow, ncol, device=self.device)

    def _sample_output_preimage(self, pre_out, state_idx, pubkey, top_pt, bottom_pt):
        params = self.injector.params
        g = PolyMatrix.gadget_matrix(params, DIAMOND_SECRET_SIZE, self.device)
        top = pubkey.matrix
        if top_pt is not None:
            top = top - g.mul_poly_scalar(top_pt)
        bottom = (
            -g.mul_poly_scalar(bottom_pt)
            if bottom_pt is not None
            else self._zero(DIAMOND_SECRET_SIZE, top.ncol)
        )
        td, b = pre_out.final_checkpoint(state_idx)
        return self._trap.preimage(params, td, b, top.concat_rows([bottom]))

    # ------------------------------------------------------------------ enc

    def enc(self, msg: bool, circuit, instance: list[bool]) -> DiamondWECiphertext:
        params = self.injector.params
        if circuit.num_output != 1:
            raise ValueError("DiamondWE requires one circuit output")
        if self.witness_size + len(instance) != circuit.num_input:
            raise ValueError(f"{self.witness_size} witness + {len(instance)} instance bits for "
                             f"a circuit of {circuit.num_input} inputs")
        self.artifact_dir.mkdir(parents=True, exist_ok=True)

        k = (Poly.const(params, params.modulus // 2, self.device) if msg
             else Poly.zero(params, device=self.device))
        pre_out = self.injector.preprocess(self.artifact_dir, k)
        hash_key = os.urandom(32) if self._seed is None else bytes([self._seed % 256] * 32)
        one_pubkey, k_pubkey, witness_pubkeys = self._sample_bgg_public_keys(hash_key)
        input_pubkeys = witness_pubkeys + self._instance_wires(one_pubkey, instance)
        out_pubkey = circuit.eval(params, one_pubkey, input_pubkeys)[0]

        one_pt = Poly.one(params, self.device)
        self._write(
            "one_preimage",
            self._sample_output_preimage(pre_out, 0, one_pubkey, one_pt, None),
        )
        for bit_idx, pk in enumerate(witness_pubkeys):
            digit_idx = bit_idx // self.injector.batch_bits
            bit_in_digit = bit_idx % self.injector.batch_bits
            state_idx = self.injector.bit_state_idx(digit_idx, bit_in_digit)
            self._write(
                f"witness_preimage_{bit_idx}",
                self._sample_output_preimage(pre_out, state_idx, pk, None, one_pt),
            )
        # k preimage: target [A_k ; I] so state0 projection gives sigma*A_k + k
        ident = PolyMatrix.identity(params, DIAMOND_SECRET_SIZE, device=self.device)
        td0, b0 = pre_out.final_checkpoint(0)
        self._write(
            "k_preimage",
            self._trap.preimage(params, td0, b0, k_pubkey.matrix.concat_rows([ident])),
        )

        r = self._sample_r(hash_key)
        dec_pubkey = k_pubkey.matrix + (one_pubkey.matrix - out_pubkey.matrix).mul_decompose(r)
        bottom = self._zero(DIAMOND_SECRET_SIZE, dec_pubkey.ncol)
        self._write(
            "decoder_preimage",
            self._trap.preimage(params, td0, b0, dec_pubkey.concat_rows([bottom])),
        )
        return DiamondWECiphertext(circuit, list(instance), hash_key, pre_out)

    # ------------------------------------------------------------------ dec

    def dec(self, ct: DiamondWECiphertext, witness: list[bool]) -> bool:
        q = self.injector.params.modulus
        coeff = self._noisy_coeff(ct, witness)
        return not (coeff < q // 4 or coeff > 3 * (q // 4))

    def _noisy_coeff(self, ct: DiamondWECiphertext, witness: list[bool]) -> int:
        """The constant coefficient of noisy = -k + (1 - y) sigma r + error."""
        params = self.injector.params
        digits = self._pack_witness_digits(witness)
        states = self.injector.online_eval(self.artifact_dir, ct.preprocess_out, digits)
        one_pubkey, k_pubkey, witness_pubkeys = self._sample_bgg_public_keys(ct.hash_key)
        one_encoding = BggEncoding(
            states[0] @ self._read("one_preimage"), one_pubkey, Poly.one(params, self.device)
        )
        k_encoding = BggEncoding(states[0] @ self._read("k_preimage"), k_pubkey, None)
        input_encodings = []
        for bit_idx, pk in enumerate(witness_pubkeys):
            digit_idx = bit_idx // self.injector.batch_bits
            bit_in_digit = bit_idx % self.injector.batch_bits
            state_idx = self.injector.bit_state_idx(digit_idx, bit_in_digit)
            bit = self.injector.digit_bit_value(digits[digit_idx], bit_in_digit)
            input_encodings.append(
                BggEncoding(
                    states[state_idx] @ self._read(f"witness_preimage_{bit_idx}"),
                    pk,
                    Poly.const(params, bit, self.device),
                )
            )
        input_encodings.extend(self._instance_wires(one_encoding, ct.instance))
        out_encoding = ct.circuit.eval(params, one_encoding, input_encodings)[0]

        r = self._sample_r(ct.hash_key)
        dec_term = one_encoding - out_encoding
        dec_vector = k_encoding.vector + dec_term.vector.mul_decompose(r)
        decoder = states[0] @ self._read("decoder_preimage")
        noisy = decoder - dec_vector
        return noisy.entry(0, 0).const_coeff()
