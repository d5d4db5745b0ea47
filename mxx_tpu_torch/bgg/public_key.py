"""BGG+ public key wire (the port's counterpart of `mxx_tpu/bgg/public_key.py`)."""

from __future__ import annotations

from dataclasses import dataclass

from ..matrix import PolyMatrix
from ..ring.poly import scalar_poly


@dataclass(frozen=True)
class BggPublicKey:
    matrix: PolyMatrix  # d x (d * modulus_digits)
    reveal_plaintext: bool

    def __add__(self, other: "BggPublicKey") -> "BggPublicKey":
        return BggPublicKey(
            self.matrix + other.matrix, self.reveal_plaintext and other.reveal_plaintext
        )

    def __sub__(self, other: "BggPublicKey") -> "BggPublicKey":
        return BggPublicKey(
            self.matrix - other.matrix, self.reveal_plaintext and other.reveal_plaintext
        )

    def concat_columns(self, others: list["BggPublicKey"]) -> "BggPublicKey":
        mat = self.matrix.concat_columns([o.matrix for o in others])
        reveal = all([self.reveal_plaintext] + [o.reveal_plaintext for o in others])
        return BggPublicKey(mat, reveal)

    def __mul__(self, other: "BggPublicKey") -> "BggPublicKey":
        """Homomorphic Mul on pubkey wires: A_out = A1 * G^{-1}(A2)."""
        return BggPublicKey(
            self.matrix.mul_decompose(other.matrix),
            self.reveal_plaintext and other.reveal_plaintext,
        )

    # Evaluable surface

    def small_scalar_mul(self, params, scalar: list[int]) -> "BggPublicKey":
        p = scalar_poly(params, scalar, self.matrix.data.device)
        return BggPublicKey(self.matrix.mul_poly_scalar(p), self.reveal_plaintext)

    def large_scalar_mul(self, params, scalar: list[int]) -> "BggPublicKey":
        device = self.matrix.data.device
        p = scalar_poly(params, scalar, device)
        scalar_gadget = PolyMatrix.gadget_matrix(params, self.matrix.nrow, device).mul_poly_scalar(p)
        return BggPublicKey(self.matrix.mul_decompose(scalar_gadget), self.reveal_plaintext)

    def matrix_mul(self, params, rhs_matrix: PolyMatrix) -> "BggPublicKey":
        return BggPublicKey(self.matrix.mul_decompose(rhs_matrix), self.reveal_plaintext)

    def __eq__(self, other):
        if not isinstance(other, BggPublicKey):
            return NotImplemented
        return self.reveal_plaintext == other.reveal_plaintext and self.matrix == other.matrix

    def __hash__(self):
        return id(self)
