"""BGG+ encoding wire: c = s*A - x*(s*G) + e.

The port's counterpart of `mxx_tpu/bgg/encoding.py`. Homomorphic algebra:
Add/Sub are componentwise; Mul is
    c_out = c1 * G^{-1}(A2) + x1 * c2,   A_out = A1 * G^{-1}(A2),
preserving the invariant c = s*A_out - (x1*x2)*(s*G) + err.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..matrix import PolyMatrix
from ..ring.poly import Poly, scalar_poly
from .public_key import BggPublicKey


@dataclass(frozen=True)
class BggEncoding:
    vector: PolyMatrix  # 1 x (d * modulus_digits)
    pubkey: BggPublicKey
    plaintext: Poly | None

    def concat_vector(self, others: list["BggEncoding"]) -> PolyMatrix:
        return self.vector.concat_columns([o.vector for o in others])

    def __add__(self, other: "BggEncoding") -> "BggEncoding":
        pt = (
            self.plaintext + other.plaintext
            if self.plaintext is not None and other.plaintext is not None
            else None
        )
        return BggEncoding(self.vector + other.vector, self.pubkey + other.pubkey, pt)

    def __sub__(self, other: "BggEncoding") -> "BggEncoding":
        pt = (
            self.plaintext - other.plaintext
            if self.plaintext is not None and other.plaintext is not None
            else None
        )
        return BggEncoding(self.vector - other.vector, self.pubkey - other.pubkey, pt)

    def __mul__(self, other: "BggEncoding") -> "BggEncoding":
        if self.plaintext is None:
            raise ValueError("unknown plaintext for the left-hand input of multiplication")
        decomposed = other.pubkey.matrix.decompose()
        first_term = self.vector @ decomposed
        second_term = other.vector.mul_poly_scalar(self.plaintext)
        new_pubkey = BggPublicKey(
            self.pubkey.matrix @ decomposed,
            self.pubkey.reveal_plaintext and other.pubkey.reveal_plaintext,
        )
        pt = self.plaintext * other.plaintext if other.plaintext is not None else None
        return BggEncoding(first_term + second_term, new_pubkey, pt)

    # Evaluable surface

    def small_scalar_mul(self, params, scalar: list[int]) -> "BggEncoding":
        p = scalar_poly(params, scalar, self.vector.data.device)
        return BggEncoding(
            self.vector.mul_poly_scalar(p),
            BggPublicKey(self.pubkey.matrix.mul_poly_scalar(p), self.pubkey.reveal_plaintext),
            self.plaintext * p if self.plaintext is not None else None,
        )

    def large_scalar_mul(self, params, scalar: list[int]) -> "BggEncoding":
        device = self.vector.data.device
        p = scalar_poly(params, scalar, device)
        gadget = PolyMatrix.gadget_matrix(params, self.pubkey.matrix.nrow, device)
        decomposed = gadget.mul_poly_scalar(p).decompose()
        return BggEncoding(
            self.vector @ decomposed,
            BggPublicKey(self.pubkey.matrix @ decomposed, self.pubkey.reveal_plaintext),
            self.plaintext * p if self.plaintext is not None else None,
        )

    def concat_columns(self, others: list["BggEncoding"]) -> "BggEncoding":
        vector = self.concat_vector(others)
        pubkey = self.pubkey.concat_columns([o.pubkey for o in others])
        return BggEncoding(vector, pubkey, None)

    def matrix_mul(self, params, rhs_matrix: PolyMatrix) -> "BggEncoding":
        decomposed = rhs_matrix.decompose()
        return BggEncoding(
            self.vector @ decomposed,
            BggPublicKey(self.pubkey.matrix @ decomposed, self.pubkey.reveal_plaintext),
            None,
        )

    def __eq__(self, other):
        if not isinstance(other, BggEncoding):
            return NotImplemented
        return (
            self.vector == other.vector
            and self.pubkey == other.pubkey
            and self.plaintext == other.plaintext
        )

    def __hash__(self):
        return id(self)
