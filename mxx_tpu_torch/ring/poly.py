"""DCRT polynomial: int64[L, n] residue tensor with a COEFF/EVAL format flag.

The port's counterpart of `mxx_tpu/ring/poly.py`. EVAL format = the
bit-reversed negacyclic evaluation order produced by `ring.ntt.ntt_fwd`.
Serialization is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.elementwise import ew_add, ew_mul, ew_neg, ew_sub
from .ntt import ntt_fwd_auto, ntt_inv_auto
from .params import RingParams

COEFF = "coeff"
EVAL = "eval"


def residues_from_int(params: RingParams, value: int) -> np.ndarray:
    """Per-limb residues [L] of a (possibly big) integer."""
    return np.array([value % q for q in params.moduli], dtype=np.uint32)


@dataclass(frozen=True)
class Poly:
    """An element of R_q = Z_q[x]/(x^n + 1) in DCRT (RNS) representation."""

    data: torch.Tensor  # int64[L, n]
    fmt: str
    params: RingParams

    # ------------------------------------------------------------ construct

    @staticmethod
    def zero(params: RingParams, fmt: str = EVAL, device="cpu") -> "Poly":
        return Poly(
            torch.zeros((params.crt_depth, params.n), dtype=torch.int64, device=device), fmt, params
        )

    @staticmethod
    def const(params: RingParams, value: int, device="cpu") -> "Poly":
        """Constant polynomial (value in every EVAL slot)."""
        res = torch.from_numpy(residues_from_int(params, value).astype(np.int64)).to(device)
        return Poly(res[:, None].expand(params.crt_depth, params.n).contiguous(), EVAL, params)

    @staticmethod
    def one(params: RingParams, device="cpu") -> "Poly":
        return Poly.const(params, 1, device)

    # --------------------------------------------------------------- format

    def to_eval(self) -> "Poly":
        if self.fmt == EVAL:
            return self
        return Poly(ntt_fwd_auto(self.data, self.params), EVAL, self.params)

    def to_coeff(self) -> "Poly":
        if self.fmt == COEFF:
            return self
        return Poly(ntt_inv_auto(self.data, self.params), COEFF, self.params)

    # ----------------------------------------------------------- arithmetic

    def _q(self) -> torch.Tensor:
        return self.params.tables(self.data.device).moduli

    def _harmonized(self, other: "Poly") -> tuple["Poly", "Poly", str]:
        if self.params is not other.params:
            raise ValueError("params mismatch")
        if self.fmt == other.fmt:
            return self, other, self.fmt
        return self.to_eval(), other.to_eval(), EVAL

    def __add__(self, other: "Poly") -> "Poly":
        a, b, fmt = self._harmonized(other)
        return Poly(ew_add(a.data, b.data, self._q()), fmt, self.params)

    def __sub__(self, other: "Poly") -> "Poly":
        a, b, fmt = self._harmonized(other)
        return Poly(ew_sub(a.data, b.data, self._q()), fmt, self.params)

    def __neg__(self) -> "Poly":
        return Poly(ew_neg(self.data, self._q()), self.fmt, self.params)

    def __mul__(self, other: "Poly") -> "Poly":
        a = self.to_eval()
        b = other.to_eval()
        return Poly(ew_mul(a.data, b.data, self._q()), EVAL, self.params)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Poly) or self.params is not other.params:
            return NotImplemented
        a, b, _ = self._harmonized(other)
        return bool(torch.equal(a.data, b.data))

    def __hash__(self):
        return id(self)
