"""Polynomial-matrix algebra over the DCRT ring: int64[L, r, c, n] tensors.

The port's counterpart of `mxx_tpu/matrix/poly_matrix.py`: block algebra,
gadget matrix, G^{-1} decomposition, concat/slice/transpose, the Kronecker
product, the exact eval-domain matmul, modulus switching and the compact
bytes of the JAX package (uint32 residues after a 25-byte header).
Out-of-core matrices are in `offload.py`. The packed bytes and the
tensor-identity products are not ported yet.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_add, ew_mul, ew_mul_const, ew_neg, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.element import FinRingElem
from ..ring.ntt import ntt_fwd_auto, ntt_inv_auto
from ..ring.params import RingParams
from ..ring.poly import COEFF, EVAL, Poly, residues_from_int

_MAGIC = b"MXTM"


def compact_header(params: RingParams, fmt: str, nrow: int, ncol: int) -> bytes:
    """The 25-byte header of a matrix's compact bytes; uint32 residues
    [L, nrow, ncol, n] follow it."""
    return _MAGIC + struct.pack(
        "<BBIIIIHB", 1, 0 if fmt == COEFF else 1, nrow, ncol, params.n, params.crt_depth,
        params.crt_bits, params.base_bits,
    )


@dataclass(frozen=True)
class PolyMatrix:
    data: torch.Tensor  # int64[L, nrow, ncol, n]
    fmt: str
    params: RingParams

    # ------------------------------------------------------------ construct

    @staticmethod
    def zero(params: RingParams, nrow: int, ncol: int, fmt: str = EVAL, device="cuda") -> "PolyMatrix":
        return PolyMatrix(
            torch.zeros((params.crt_depth, nrow, ncol, params.n), dtype=torch.int64, device=device),
            fmt,
            params,
        )

    @staticmethod
    def identity(params: RingParams, size: int, scalar: Poly | None = None,
                 device="cuda") -> "PolyMatrix":
        diag = Poly.one(params, device) if scalar is None else scalar.to_eval()
        data = torch.zeros((params.crt_depth, size, size, params.n), dtype=torch.int64,
                           device=diag.data.device)
        idx = torch.arange(size, device=data.device)
        data[:, idx, idx, :] = diag.data[:, None, :]
        return PolyMatrix(data, EVAL, params)

    @staticmethod
    def from_polys(params: RingParams, rows: list[list[Poly]]) -> "PolyMatrix":
        """Matrix of polys given row by row (EVAL if their formats differ)."""
        fmts = {p.fmt for r in rows for p in r}
        fmt = EVAL if len(fmts) > 1 else fmts.pop()
        datas = [[(p.to_eval() if fmt == EVAL else p).data for p in row] for row in rows]
        data = torch.stack([torch.stack(r, dim=1) for r in datas], dim=1)
        if data.shape != (params.crt_depth, len(rows), len(rows[0]), params.n):
            raise ValueError(f"polys of shape {tuple(data.shape)} do not match {params}")
        return PolyMatrix(data, fmt, params)

    @staticmethod
    def from_poly_row(params: RingParams, polys: list[Poly]) -> "PolyMatrix":
        return PolyMatrix.from_polys(params, [polys])

    @staticmethod
    def from_poly_column(params: RingParams, polys: list[Poly]) -> "PolyMatrix":
        return PolyMatrix.from_polys(params, [[p] for p in polys])

    @staticmethod
    def scaled_unit_column_vector(params: RingParams, size: int, index: int,
                                  scalar: Poly) -> "PolyMatrix":
        """size x 1 column with `scalar` at row `index`, zero elsewhere (EVAL),
        on the scalar's device."""
        if not 0 <= index < size:
            raise ValueError(f"unit column index {index} out of range for size {size}")
        s = scalar.to_eval().data
        data = torch.zeros((params.crt_depth, size, 1, params.n), dtype=torch.int64,
                           device=s.device)
        data[:, index, 0, :] = s
        return PolyMatrix(data, EVAL, params)

    @staticmethod
    def unit_column_vector(params: RingParams, size: int, index: int,
                           device="cuda") -> "PolyMatrix":
        return PolyMatrix.scaled_unit_column_vector(params, size, index,
                                                    Poly.one(params, device))

    @staticmethod
    def gadget_matrix(params: RingParams, size: int, device="cuda") -> "PolyMatrix":
        """G = I_size tensor g, g the k-digit gadget row vector (EVAL form).

        Entries are constant polys with residues `np_gadget_res[idx, limb]`.
        Cached per (params, size, device)."""
        device = torch.device(device)
        cache = params._tables.setdefault("gadget_matrix_cache", {})
        key = (size, str(device))
        if key not in cache:
            k = params.modulus_digits
            gv = params.tables(device).gadget_res  # [k, L]
            eye = torch.eye(size, dtype=torch.int64, device=device)
            # out[l, i, j*k+m] = eye[i, j] * gv[m, l] (a broadcast product:
            # CUDA has no integer einsum)
            out = (eye[None, :, :, None] * gv.T[:, None, None, :]).reshape(
                params.crt_depth, size, size * k
            )
            data = out[..., None].expand(out.shape + (params.n,)).contiguous()
            cache[key] = PolyMatrix(data, EVAL, params)
        return cache[key]

    # ------------------------------------------------------------- shape ops

    @property
    def nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ncol(self) -> int:
        return self.data.shape[2]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrow, self.ncol)

    def entry(self, i: int, j: int) -> Poly:
        return Poly(self.data[:, i, j, :], self.fmt, self.params)

    def slice(self, row_start: int, row_end: int, col_start: int, col_end: int) -> "PolyMatrix":
        return PolyMatrix(
            self.data[:, row_start:row_end, col_start:col_end, :], self.fmt, self.params
        )

    def slice_rows(self, start: int, end: int) -> "PolyMatrix":
        return self.slice(start, end, 0, self.ncol)

    def slice_columns(self, start: int, end: int) -> "PolyMatrix":
        return self.slice(0, self.nrow, start, end)

    def transpose(self) -> "PolyMatrix":
        return PolyMatrix(self.data.transpose(1, 2), self.fmt, self.params)

    def tensor(self, other: "PolyMatrix") -> "PolyMatrix":
        """Kronecker product with pointwise poly products (EVAL form)."""
        a = self.to_eval().data
        b = other.to_eval().data
        L, n = a.shape[0], a.shape[-1]
        z = ew_mul(a[:, :, None, :, None, :], b[:, None, :, None, :, :], self._q())
        return PolyMatrix(
            z.reshape(L, self.nrow * other.nrow, self.ncol * other.ncol, n), EVAL, self.params
        )

    def concat_columns(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        mats = [self] + list(others)
        datas = [m._convert(self.fmt).data for m in mats]
        return PolyMatrix(torch.cat(datas, dim=2), self.fmt, self.params)

    def concat_rows(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        mats = [self] + list(others)
        datas = [m._convert(self.fmt).data for m in mats]
        return PolyMatrix(torch.cat(datas, dim=1), self.fmt, self.params)

    # --------------------------------------------------------------- format

    def _convert(self, fmt: str) -> "PolyMatrix":
        return self.to_eval() if fmt == EVAL else self.to_coeff()

    def to_eval(self) -> "PolyMatrix":
        if self.fmt == EVAL:
            return self
        return PolyMatrix(ntt_fwd_auto(self.data, self.params), EVAL, self.params)

    def to_coeff(self) -> "PolyMatrix":
        if self.fmt == COEFF:
            return self
        return PolyMatrix(ntt_inv_auto(self.data, self.params), COEFF, self.params)

    # ----------------------------------------------------------- arithmetic

    def _q(self) -> torch.Tensor:
        return self.params.tables(self.data.device).moduli

    def _harmonized(self, other: "PolyMatrix"):
        if self.params is not other.params:
            raise ValueError("params mismatch")
        if self.fmt == other.fmt:
            return self, other, self.fmt
        return self.to_eval(), other.to_eval(), EVAL

    def __add__(self, other: "PolyMatrix") -> "PolyMatrix":
        a, b, fmt = self._harmonized(other)
        return PolyMatrix(ew_add(a.data, b.data, self._q()), fmt, self.params)

    def __sub__(self, other: "PolyMatrix") -> "PolyMatrix":
        a, b, fmt = self._harmonized(other)
        return PolyMatrix(ew_sub(a.data, b.data, self._q()), fmt, self.params)

    def __neg__(self) -> "PolyMatrix":
        return PolyMatrix(ew_neg(self.data, self._q()), self.fmt, self.params)

    def __matmul__(self, other: "PolyMatrix") -> "PolyMatrix":
        if self.ncol != other.nrow:
            raise ValueError(f"shape mismatch {self.shape} @ {other.shape}")
        a = self.to_eval().data
        b = other.to_eval().data
        return PolyMatrix(zq_matmul(a, b, self._q()), EVAL, self.params)

    def __mul__(self, other):
        """Matrix * matrix, matrix * Poly (scalar), or matrix * int/FinRingElem."""
        if isinstance(other, PolyMatrix):
            return self @ other
        if isinstance(other, Poly):
            return self.mul_poly_scalar(other)
        if isinstance(other, FinRingElem):
            return self.mul_int_scalar(other.value)
        if isinstance(other, int):
            return self.mul_int_scalar(other)
        return NotImplemented

    def mul_poly_scalar(self, scalar: Poly) -> "PolyMatrix":
        a = self.to_eval().data
        s = scalar.to_eval().data
        return PolyMatrix(ew_mul(a, s[:, None, None, :], self._q()), EVAL, self.params)

    def mul_int_scalar(self, value: int) -> "PolyMatrix":
        res = residues_from_int(self.params, value).astype(np.int64)
        c = torch.from_numpy(res).to(self.data.device)
        return PolyMatrix(ew_mul_const(self.data, c, self._q()), self.fmt, self.params)

    def __eq__(self, other) -> bool:
        if not isinstance(other, PolyMatrix) or self.params is not other.params:
            return NotImplemented
        if self.shape != other.shape:
            return False
        a, b, _ = self._harmonized(other)
        return bool(torch.equal(a.data, b.data))

    def __hash__(self):
        return id(self)

    # --------------------------------------------------------- decomposition

    def decompose(self) -> "PolyMatrix":
        """G^{-1}: [r, c] -> [r*k, c] with per-tower digits."""
        p = self.params
        data = self.to_coeff().data
        t = p.tables(data.device)
        out = digit_decompose(
            data,
            t.moduli,
            t.digit_masks,
            base_bits=p.base_bits,
            dpt=p.digits_per_tower,
            towers=p.crt_depth,
        )
        return PolyMatrix(out, COEFF, p)

    def get_column_matrix_decompose(self, j: int) -> "PolyMatrix":
        """G^{-1} of column j: [r, 1] -> [r*k, 1]."""
        return self.slice_columns(j, j + 1).decompose()

    def mul_decompose(self, other: "PolyMatrix") -> "PolyMatrix":
        """self @ G^{-1}(other): self [*, d*k], other [d, m] -> [*, m]."""
        k = self.params.modulus_digits
        if self.ncol != other.nrow * k:
            raise ValueError(f"shape mismatch {self.shape} @ G^-1 of {other.shape}, k={k}")
        return self @ other.decompose()

    def modulus_switch(self, new_modulus: int) -> "PolyMatrix":
        """Round-scale every coefficient from q to new_modulus: round(x P / q)
        mod P, re-embedded per limb (COEFF form).

        For P < 2^32 the CRT scale-and-round of the JAX package
        (`_modulus_switch_u32`) in int64 on the matrix's device: with
        e_t P / q = I_t + f_t, the integer parts r_t (I_t mod P) (each below
        2^63, since r_t < 2^31 and I_t mod P < 2^32) accumulate exactly mod P,
        and the fractions r_t f_t accumulate in float64 limb by limb in the
        JAX package's order, with the same `>= 0.5` rule. A coefficient whose
        true fraction lies within ~2^-20 of 1/2 may round the other way than
        the exact integer rounding; both packages round it alike. Larger
        targets take the exact host big-int path."""
        p = self.params
        q = p.modulus
        coeff = self.to_coeff().data
        if new_modulus < (1 << 32):
            device = coeff.device
            ints_np, fracs_np = p.ms_tables(new_modulus)
            ints = torch.from_numpy(ints_np).to(device)
            P = torch.tensor(new_modulus, dtype=torch.int64, device=device)
            hi = torch.zeros(coeff.shape[1:], dtype=torch.int64, device=device)
            fr = torch.zeros(coeff.shape[1:], dtype=torch.float64, device=device)
            for t in range(p.crt_depth):
                r = coeff[t]
                hi = (hi + (r * ints[t]) % P) % P
                fr = fr + r.to(torch.float64) * float(fracs_np[t])
            fr_floor = torch.floor(fr)
            carry = (fr_floor.to(torch.int64) + (fr - fr_floor >= 0.5).to(torch.int64)) % P
            v = (hi + carry) % P
            moduli = p.tables(device).moduli.reshape(-1, 1, 1, 1)
            return PolyMatrix(v[None] % moduli, COEFF, p)
        arr = coeff.cpu().numpy()
        rows = []
        for i in range(self.nrow):
            row = []
            for j in range(self.ncol):
                coeffs = [p.reconstruct_coeff(arr[:, i, j, t]) for t in range(p.n)]
                switched = [(c * new_modulus + q // 2) // q % new_modulus for c in coeffs]
                row.append(Poly.from_int_coeffs(p, switched, coeff.device))
            rows.append(row)
        return PolyMatrix.from_polys(p, rows)

    # ---------------------------------------------------------------- serde

    def to_compact_bytes(self) -> bytes:
        arr = self.data.cpu().numpy().astype(np.uint32)
        return compact_header(self.params, self.fmt, self.nrow, self.ncol) + arr.tobytes()

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes, device="cuda") -> "PolyMatrix":
        if raw[:4] != _MAGIC:
            raise ValueError("bad matrix magic")
        ver, fmt_i, nrow, ncol, n, depth, _crt_bits, _base_bits = struct.unpack(
            "<BBIIIIHB", raw[4:25]
        )
        if ver != 1 or n != params.n or depth != params.crt_depth:
            raise ValueError(f"matrix bytes v{ver} n={n} L={depth} do not match {params}")
        # residues are below 2^31: move them as int32 and widen on the device
        arr = np.frombuffer(raw, dtype=np.int32, count=depth * nrow * ncol * n, offset=25)
        data = torch.from_numpy(arr.reshape(depth, nrow, ncol, n).copy()).to(device)
        return PolyMatrix(data.to(torch.int64), COEFF if fmt_i == 0 else EVAL, params)
