"""Functional encryption surface + AKY24-style FE (the port's counterpart of
`mxx_tpu/func_enc/fe.py`, with the same domain-separated subkeys, so seeded
runs draw what the JAX package draws):

- secret s = [s', 1] (d = 2, last coordinate fixed to one), trapdoor (B, T);
- Enc(x): BGG encodings of the message bits under s plus c_b ~ s*B;
- KeyGen(f): evaluate f over the hash-derived pubkeys to get A_f, publish
      K_f = B^{-1}( A_f * G^{-1}( (q/2) e_last ) );
- Dec: evaluate f over the encodings to get c_f, then
      c_b * K_f - c_f * G^{-1}((q/2) e_last) = (q/2) f(x) + noise,
  rounded to a bit. The unit last secret coordinate turns the s-scaled BGG
  plaintext channel into an absolute (q/2)-scaled channel.

Everything runs on the constructor's `device`.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import torch

from ..bgg import BGGEncodingSampler, BGGPublicKeySampler
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import GaussDist, TernaryDist, Trapdoor, TrapdoorSampler, UniformSampler

D_SECRET = 2


class FuncEnc:
    """Protocol surface."""

    def setup(self, params):
        raise NotImplementedError

    def enc(self, params, enc_key, msg):
        raise NotImplementedError

    def keygen(self, params, msk, func):
        raise NotImplementedError

    def dec(self, params, ct, fsk):
        raise NotImplementedError


class NoCircuitEvaluator:
    """Raising stand-in where LUT/slot gates must not occur."""

    def public_lookup(self, *args, **kwargs):
        raise RuntimeError("NoCircuitEvaluator does not support public lookup gates")

    def slot_transfer(self, *args, **kwargs):
        raise RuntimeError("NoCircuitEvaluator does not support slot-transfer gates")

    def slot_reduce(self, *args, **kwargs):
        raise RuntimeError("NoCircuitEvaluator does not support slot-reduce gates")


@dataclass
class Aky24MasterKey:
    secrets: list[Poly]
    trapdoor: Trapdoor
    b_matrix: PolyMatrix


@dataclass
class Aky24Ciphertext:
    encodings: list  # [one] + per-bit BggEncoding
    c_b: PolyMatrix


@dataclass
class Aky24FuncKey:
    k_f: PolyMatrix


class Aky24FuncEnc(FuncEnc):
    def __init__(self, msg_bits: int, error_sigma: float = 0.0,
                 trapdoor_sigma: float = 4.578, seed: int | None = None, device="cuda"):
        self.msg_bits = msg_bits
        self.error_sigma = error_sigma
        self.trapdoor_sigma = trapdoor_sigma
        self.seed = seed
        self.device = torch.device(device)
        # every randomness consumer gets a domain-separated subkey: seeded
        # runs share no ChaCha stream between the secret draw, per-call
        # encryption errors and preimage Gaussians; hash_key is a digest
        self._root = (
            os.urandom(32)
            if seed is None
            else hashlib.sha256(
                b"aky24_fe_root/v1" + int(seed).to_bytes(16, "little", signed=True)
            ).digest()
        )
        self.hash_key = self._subkey(b"hash_key")
        self._enc_counter = 0
        self._keygen_counter = 0

    def _subkey(self, purpose: bytes, counter: int = 0) -> bytes:
        return hashlib.sha256(
            b"aky24_fe_sub/v1|" + self._root + b"|" + purpose + b"|"
            + counter.to_bytes(8, "little")
        ).digest()

    def _pubkeys(self, params):
        return BGGPublicKeySampler(self.hash_key, D_SECRET, self.device).sample(
            params, b"aky24_fe", [True] * self.msg_bits
        )

    def _decode_selector(self, params) -> PolyMatrix:
        u = PolyMatrix.scaled_unit_column_vector(
            params, D_SECRET, D_SECRET - 1, Poly.const(params, params.modulus // 2, self.device)
        )
        return u.decompose()  # m x 1

    def setup(self, params):
        us = UniformSampler(self._subkey(b"setup_secret"), self.device)
        s_prime = us.sample_poly(params, TernaryDist())
        secrets = [s_prime, Poly.one(params, self.device)]
        ts = TrapdoorSampler(params, self.trapdoor_sigma,
                             seed=self._subkey(b"setup_trapdoor"), device=self.device)
        trapdoor, b = ts.trapdoor(params, D_SECRET)
        return self.hash_key, Aky24MasterKey(secrets, trapdoor, b)

    def enc(self, params, enc_key, msg: list[int]) -> Aky24Ciphertext:
        if len(msg) != self.msg_bits:
            raise ValueError(f"{len(msg)} message bits for msg_bits={self.msg_bits}")
        # the master secret is needed to encrypt in this scheme shape: the
        # encryptor holds s (symmetric-key FE, as in AKY24's wrapper)
        if not isinstance(enc_key, Aky24MasterKey):
            raise TypeError("Aky24FuncEnc.enc requires the master key")
        pubkeys = self._pubkeys(params)
        # per-call subkeys: two encryptions never share an error stream, and
        # none shares with setup's secret draw
        call = self._enc_counter
        self._enc_counter += 1
        sampler = BGGEncodingSampler(
            params,
            enc_key.secrets,
            self.error_sigma or None,
            seed=self._subkey(b"enc_encodings", call),
        )
        plaintexts = [Poly.const(params, b, self.device) for b in msg]
        encodings = sampler.sample(params, pubkeys, plaintexts)
        c_b = sampler.secret_vec @ enc_key.b_matrix
        if self.error_sigma:
            c_b = c_b + UniformSampler(
                self._subkey(b"enc_cb_error", call), self.device
            ).sample_uniform(params, 1, c_b.ncol, GaussDist(self.error_sigma))
        return Aky24Ciphertext(encodings, c_b)

    def keygen(self, params, msk: Aky24MasterKey, func) -> Aky24FuncKey:
        pubkeys = self._pubkeys(params)
        a_f = func.eval(params, pubkeys[0], pubkeys[1:])[0]
        target = a_f.matrix @ self._decode_selector(params)  # d x 1
        call = self._keygen_counter
        self._keygen_counter += 1
        ts = TrapdoorSampler(params, self.trapdoor_sigma,
                             seed=self._subkey(b"keygen_preimage", call), device=self.device)
        k_f = ts.preimage(params, msk.trapdoor, msk.b_matrix, target)
        return Aky24FuncKey(k_f)

    def dec(self, params, ct: Aky24Ciphertext, fsk: Aky24FuncKey, func) -> int:
        q = params.modulus
        coeff = self._noisy_coeff(params, ct, fsk, func)
        return 0 if (coeff < q // 4 or coeff > 3 * (q // 4)) else 1

    def _noisy_coeff(self, params, ct: Aky24Ciphertext, fsk: Aky24FuncKey, func) -> int:
        """The constant coefficient of c_b K_f - c_f G^{-1}((q/2) e_last)."""
        c_f = func.eval(params, ct.encodings[0], ct.encodings[1:])[0]
        sel = self._decode_selector(params)
        noisy = ct.c_b @ fsk.k_f - c_f.vector @ sel
        return noisy.entry(0, 0).const_coeff()
