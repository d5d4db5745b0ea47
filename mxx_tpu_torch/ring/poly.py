"""DCRT polynomial: int64[L, n] residue tensor with a COEFF/EVAL format flag.

The port's counterpart of `mxx_tpu/ring/poly.py`. EVAL format = the
bit-reversed negacyclic evaluation order produced by `ring.ntt.ntt_fwd`.
The compact bytes are the JAX package's format (uint32 residues after a
17-byte header), so either package reads what the other wrote.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.elementwise import ew_add, ew_mul, ew_neg, ew_sub
from .ntt import ntt_fwd_auto, ntt_inv_auto
from .params import RingParams

COEFF = "coeff"
EVAL = "eval"

_MAGIC = b"MXTP"


def residues_from_int(params: RingParams, value: int) -> np.ndarray:
    """Per-limb residues [L] of a (possibly big) integer."""
    return np.array([value % q for q in params.moduli], dtype=np.uint32)


def residue_planes_from_ints(params: RingParams, values) -> np.ndarray:
    """[L, len(values)] residue planes from a list of Python ints."""
    out = np.empty((params.crt_depth, len(values)), dtype=np.uint32)
    vals = [int(v) for v in values]
    if all(0 <= v < (1 << 63) for v in vals):
        arr = np.array(vals, dtype=np.uint64)
        for t, q in enumerate(params.moduli):
            out[t] = (arr % np.uint64(q)).astype(np.uint32)
    else:
        for t, q in enumerate(params.moduli):
            out[t] = np.array([v % q for v in vals], dtype=np.uint32)
    return out


@dataclass(frozen=True)
class Poly:
    """An element of R_q = Z_q[x]/(x^n + 1) in DCRT (RNS) representation."""

    data: torch.Tensor  # int64[L, n]
    fmt: str
    params: RingParams

    # ------------------------------------------------------------ construct

    @staticmethod
    def zero(params: RingParams, fmt: str = EVAL, device="cuda") -> "Poly":
        return Poly(
            torch.zeros((params.crt_depth, params.n), dtype=torch.int64, device=device), fmt, params
        )

    @staticmethod
    def const(params: RingParams, value: int, device="cuda") -> "Poly":
        """Constant polynomial (value in every EVAL slot)."""
        res = torch.from_numpy(residues_from_int(params, value).astype(np.int64)).to(device)
        return Poly(res[:, None].expand(params.crt_depth, params.n).contiguous(), EVAL, params)

    @staticmethod
    def one(params: RingParams, device="cuda") -> "Poly":
        return Poly.const(params, 1, device)

    @staticmethod
    def from_elem_to_constant(params: RingParams, elem, device="cuda") -> "Poly":
        """Constant polynomial of a `FinRingElem`."""
        return Poly.const(params, elem.value, device)

    @staticmethod
    def from_int_coeffs(params: RingParams, coeffs, device="cuda") -> "Poly":
        """Coefficient-order construction from ints (arbitrary precision)."""
        if len(coeffs) != params.n:
            raise ValueError(f"{len(coeffs)} coefficients for n={params.n}")
        planes = residue_planes_from_ints(params, coeffs).astype(np.int64)
        return Poly(torch.from_numpy(planes).to(device), COEFF, params)

    # --------------------------------------------------------------- format

    def to_eval(self) -> "Poly":
        if self.fmt == EVAL:
            return self
        return Poly(ntt_fwd_auto(self.data, self.params), EVAL, self.params)

    def to_coeff(self) -> "Poly":
        if self.fmt == COEFF:
            return self
        return Poly(ntt_inv_auto(self.data, self.params), COEFF, self.params)

    # ------------------------------------------------------------ accessors

    def coeffs(self) -> list[int]:
        """Big-int coefficients in [0, q) (host CRT reconstruction)."""
        arr = self.to_coeff().data.cpu().numpy()
        p = self.params
        return [p.reconstruct_coeff(arr[:, j]) for j in range(p.n)]

    def const_coeff(self) -> int:
        arr = self.to_coeff().data[:, 0].cpu().numpy()
        return self.params.reconstruct_coeff(arr)

    def const_value(self) -> int:
        """Value of a CONSTANT polynomial without a transform: a constant has
        its value in every EVAL slot and in COEFF coefficient 0, so either
        format reads column 0 (one small device-to-host read for a poly on a
        card). Callers must know the poly is constant (LUT inputs are)."""
        return self.params.reconstruct_coeff(self.data[:, 0].cpu().numpy())

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

    # ------------------------------------------- Evaluable surface (circuits)

    def small_scalar_mul(self, params: RingParams, scalar: list[int]) -> "Poly":
        return self * scalar_poly(params, scalar, self.data.device)

    def large_scalar_mul(self, params: RingParams, scalar: list[int]) -> "Poly":
        return self * scalar_poly(params, scalar, self.data.device)

    # ---------------------------------------------------------------- serde

    def to_compact_bytes(self) -> bytes:
        p = self.params
        arr = self.data.cpu().numpy().astype(np.uint32)
        header = _MAGIC + struct.pack(
            "<BBIIHB", 1, 0 if self.fmt == COEFF else 1, p.n, p.crt_depth, p.crt_bits,
            p.base_bits,
        )
        return header + arr.tobytes()

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes, device="cuda") -> "Poly":
        if raw[:4] != _MAGIC:
            raise ValueError("bad poly magic")
        ver, fmt_i, n, depth, _crt_bits, _base_bits = struct.unpack("<BBIIHB", raw[4:17])
        if ver != 1 or n != params.n or depth != params.crt_depth:
            raise ValueError(f"poly bytes v{ver} n={n} L={depth} do not match {params}")
        arr = np.frombuffer(raw[17:], dtype=np.uint32).reshape(depth, n).astype(np.int64)
        return Poly(torch.from_numpy(arr).to(device), COEFF if fmt_i == 0 else EVAL, params)


def scalar_poly(params: RingParams, scalar: list[int], device="cuda") -> Poly:
    """The polynomial with coefficients `scalar` (zero-padded to n): a gate's
    scalar. Equal to `Poly.from_int_coeffs` of the padded list; only the
    given coefficients go through the host's big-int reduction."""
    if len(scalar) > params.n:
        raise ValueError(f"{len(scalar)} scalar coefficients for n={params.n}")
    planes = np.zeros((params.crt_depth, params.n), dtype=np.int64)
    planes[:, : len(scalar)] = residue_planes_from_ints(params, scalar)
    return Poly(torch.from_numpy(planes).to(device), COEFF, params)
