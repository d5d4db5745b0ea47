"""Polynomial-matrix algebra over the DCRT ring: int64[L, r, c, n] tensors.

The port's counterpart of `mxx_tpu/matrix/poly_matrix.py`: block algebra,
the gadget and small gadget matrices, G^{-1} decomposition (full and
per-tower "small"), concat/slice/transpose, the Kronecker and
tensor-identity products, the exact eval-domain matmul, modulus switching,
and the JAX package's bytes: compact (uint32 residues after a 25-byte
header), packed (crt_bits bits per residue through the host codec, `MXPK`)
and `.mxxm` files. Residues are narrowed to 32 bits on the device before
they are copied to the host. Out-of-core matrices are in `offload.py`.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..native import pack_u32, unpack_u32
from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_add, ew_mul, ew_mul_const, ew_neg, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.element import FinRingElem
from ..ring.ntt import ntt_fwd_auto, ntt_inv_auto
from ..ring.params import RingParams
from ..ring.poly import COEFF, EVAL, Poly, residues_from_int

_MAGIC = b"MXTM"
_PACKED_MAGIC = b"MXPK"


def compact_header(params: RingParams, fmt: str, nrow: int, ncol: int,
                   magic: bytes = _MAGIC) -> bytes:
    """The 25-byte header of a matrix's compact bytes (uint32 residues
    [L, nrow, ncol, n] follow it) or, with the `MXPK` magic, of its packed
    bytes (crt_bits bits per residue follow it)."""
    return magic + struct.pack(
        "<BBIIIIHB", 1, 0 if fmt == COEFF else 1, nrow, ncol, params.n, params.crt_depth,
        params.crt_bits, params.base_bits,
    )


def _parse_header(params: RingParams, raw, magic: bytes) -> tuple:
    """(fmt, nrow, ncol, crt_bits) of a 25-byte header, checked against params."""
    if bytes(raw[:4]) != magic:
        raise ValueError(f"bad matrix magic {bytes(raw[:4])!r}, want {magic!r}")
    ver, fmt_i, nrow, ncol, n, depth, crt_bits, _base_bits = struct.unpack(
        "<BBIIIIHB", raw[4:25])
    if ver != 1 or n != params.n or depth != params.crt_depth:
        raise ValueError(f"matrix bytes v{ver} n={n} L={depth} do not match {params}")
    return COEFF if fmt_i == 0 else EVAL, nrow, ncol, crt_bits


def host_u32(data: torch.Tensor) -> np.ndarray:
    """Residue planes as a host uint32 array: narrowed to 32 bits on their
    device (residues are below 2^31), then copied."""
    return data.to(torch.int32).cpu().numpy().view(np.uint32)


def switch_terms(residues: torch.Tensor, ints: np.ndarray, fracs: np.ndarray, new_modulus: int,
                 fr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The scale-and-round terms of some limbs (`residues` int64[l, ...] and
    their rows of `RingParams.ms_tables`) on the residues' device: with
    e_t P / q = I_t + f_t, returns (sum_t r_t (I_t mod P) mod P, exact; each
    product is below 2^63, since r_t < 2^31 and I_t mod P < 2^32) and the
    float64 accumulator `fr` (moved there) plus r_t f_t, added in limb
    order."""
    device = residues.device
    ints = torch.from_numpy(np.ascontiguousarray(ints)).to(device)
    P = torch.tensor(new_modulus, dtype=torch.int64, device=device)
    hi = torch.zeros(residues.shape[1:], dtype=torch.int64, device=device)
    fr = fr.to(device)
    for t in range(residues.shape[0]):
        r = residues[t]
        hi = (hi + (r * ints[t]) % P) % P
        fr = fr + r.to(torch.float64) * float(fracs[t])
    return hi, fr


def switch_round(hi: torch.Tensor, fr: torch.Tensor, new_modulus: int) -> torch.Tensor:
    """(hi + round(fr)) mod P, rounding a fraction of exactly 1/2 up."""
    fr_floor = torch.floor(fr)
    carry = fr_floor.to(torch.int64) + (fr - fr_floor >= 0.5).to(torch.int64)
    return (hi % new_modulus + carry % new_modulus) % new_modulus


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

    @staticmethod
    def small_gadget_matrix(params: RingParams, size: int, device="cuda") -> "PolyMatrix":
        """I_size tensor (1, b, ..., b^{dpt-1}) of constant polys (EVAL form)."""
        dpt = params.digits_per_tower
        gv = torch.from_numpy(params.np_small_gadget_res.astype(np.int64)).to(device)  # [dpt, L]
        eye = torch.eye(size, dtype=torch.int64, device=device)
        out = (eye[None, :, :, None] * gv.T[:, None, None, :]).reshape(
            params.crt_depth, size, size * dpt)
        return PolyMatrix(out[..., None].expand(out.shape + (params.n,)).contiguous(), EVAL,
                          params)

    # ------------------------------------------------------------- shape ops

    @property
    def nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ncol(self) -> int:
        return self.data.shape[2]

    def row_size(self) -> int:
        return self.nrow

    def col_size(self) -> int:
        return self.ncol

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrow, self.ncol)

    def entry(self, i: int, j: int) -> Poly:
        return Poly(self.data[:, i, j, :], self.fmt, self.params)

    def get_row(self, i: int) -> list[Poly]:
        return [self.entry(i, j) for j in range(self.ncol)]

    def get_column(self, j: int) -> list[Poly]:
        return [self.entry(i, j) for i in range(self.nrow)]

    def block_entries(self, rows: range, cols: range) -> list[list[Poly]]:
        return [[self.entry(i, j) for j in cols] for i in rows]

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

    def concat_diag(self, others: list["PolyMatrix"]) -> "PolyMatrix":
        """Block-diagonal matrix of self and others (zero off the blocks)."""
        mats = [self] + list(others)
        p = self.params
        data = torch.zeros((p.crt_depth, sum(m.nrow for m in mats), sum(m.ncol for m in mats),
                            p.n), dtype=torch.int64, device=self.data.device)
        r0 = c0 = 0
        for m in mats:
            data[:, r0 : r0 + m.nrow, c0 : c0 + m.ncol, :] = m._convert(self.fmt).data
            r0 += m.nrow
            c0 += m.ncol
        return PolyMatrix(data, self.fmt, p)

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

    def _digits(self, towers: int) -> "PolyMatrix":
        p = self.params
        data = self.to_coeff().data
        t = p.tables(data.device)
        out = digit_decompose(data, t.moduli, t.digit_masks, base_bits=p.base_bits,
                              dpt=p.digits_per_tower, towers=towers)
        return PolyMatrix(out, COEFF, p)

    def decompose(self) -> "PolyMatrix":
        """G^{-1}: [r, c] -> [r*k, c] with per-tower digits."""
        return self._digits(self.params.crt_depth)

    def small_decompose(self) -> "PolyMatrix":
        """Per-tower G^{-1} for small-norm entries: [r, c] -> [r*dpt, c] (the
        digits of the first tower's residue, which is the entry itself when
        it lies below every q_t)."""
        return self._digits(1)

    def get_column_matrix_decompose(self, j: int) -> "PolyMatrix":
        """G^{-1} of column j: [r, 1] -> [r*k, 1]."""
        return self.slice_columns(j, j + 1).decompose()

    def mul_decompose(self, other: "PolyMatrix") -> "PolyMatrix":
        """self @ G^{-1}(other): self [*, d*k], other [d, m] -> [*, m].

        With MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH = w > 0, G^{-1}(other) is
        never held whole: chunks of w columns are decomposed and multiplied
        one by one, then concatenated (exact, since the digits of an entry
        depend on that entry alone)."""
        k = self.params.modulus_digits
        if self.ncol != other.nrow * k:
            raise ValueError(f"shape mismatch {self.shape} @ G^-1 of {other.shape}, k={k}")
        w = config.mul_decompose_column_chunk_width()
        if w <= 0 or other.ncol <= w:
            return self @ other.decompose()
        outs = [self @ other.slice_columns(s, min(s + w, other.ncol)).decompose()
                for s in range(0, other.ncol, w)]
        return outs[0].concat_columns(outs[1:])

    def mul_decompose_small(self, other: "PolyMatrix") -> "PolyMatrix":
        """self @ small_G^{-1}(other): self [*, d*dpt], other [d, m]."""
        dpt = self.params.digits_per_tower
        if self.ncol != other.nrow * dpt:
            raise ValueError(f"shape mismatch {self.shape} @ small G^-1 of {other.shape}")
        return self @ other.small_decompose()

    def mul_tensor_identity(self, other: "PolyMatrix", identity_size: int) -> "PolyMatrix":
        """self @ (I_identity_size tensor other), without building it."""
        w = other.nrow
        if self.ncol != w * identity_size:
            raise ValueError(f"shape mismatch {self.shape} @ I_{identity_size} x {other.shape}")
        slices = [self.slice_columns(i * w, (i + 1) * w) @ other for i in range(identity_size)]
        return slices[0].concat_columns(slices[1:])

    def mul_tensor_identity_decompose(self, other: "PolyMatrix",
                                      identity_size: int) -> "PolyMatrix":
        """self @ (I_identity_size tensor G^{-1}(other)), without building it."""
        w = other.nrow * self.params.modulus_digits
        if self.ncol != w * identity_size:
            raise ValueError(f"shape mismatch {self.shape} @ I_{identity_size} x G^-1 of "
                             f"{other.shape}")
        slices = [self.slice_columns(i * w, (i + 1) * w).mul_decompose(other)
                  for i in range(identity_size)]
        return slices[0].concat_columns(slices[1:])

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
            fr = torch.zeros(coeff.shape[1:], dtype=torch.float64, device=device)
            hi, fr = switch_terms(coeff, *p.ms_tables(new_modulus), new_modulus, fr)
            v = switch_round(hi, fr, new_modulus)
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
        return (compact_header(self.params, self.fmt, self.nrow, self.ncol)
                + host_u32(self.data).tobytes())

    @staticmethod
    def from_compact_bytes(params: RingParams, raw: bytes, device="cuda") -> "PolyMatrix":
        fmt, nrow, ncol, _ = _parse_header(params, raw, _MAGIC)
        # residues are below 2^31: move them as int32 and widen on the device
        arr = np.frombuffer(raw, dtype=np.int32, count=params.crt_depth * nrow * ncol * params.n,
                            offset=25)
        data = torch.from_numpy(arr.reshape(params.crt_depth, nrow, ncol, params.n).copy())
        return PolyMatrix(data.to(device).to(torch.int64), fmt, params)

    def to_packed_bytes(self) -> bytes:
        """The `MXPK` header, then every residue in crt_bits bits (host codec)."""
        p = self.params
        return (compact_header(p, self.fmt, self.nrow, self.ncol, _PACKED_MAGIC)
                + pack_u32(host_u32(self.data), p.crt_bits))

    @staticmethod
    def from_packed_bytes(params: RingParams, raw: bytes, device="cuda") -> "PolyMatrix":
        fmt, nrow, ncol, crt_bits = _parse_header(params, raw, _PACKED_MAGIC)
        shape = (params.crt_depth, nrow, ncol, params.n)
        arr = unpack_u32(memoryview(raw)[25:], int(np.prod(shape)), crt_bits)
        data = torch.from_numpy(arr.view(np.int32).reshape(shape))
        return PolyMatrix(data.to(device).to(torch.int64), fmt, params)

    def write_to_file(self, dir_path, mat_id: str) -> None:
        """`<dir_path>/<mat_id>.mxxm`: the compact bytes."""
        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, f"{mat_id}.mxxm"), "wb") as f:
            f.write(self.to_compact_bytes())

    @staticmethod
    def read_from_file(params: RingParams, dir_path, mat_id: str,
                       device="cuda") -> "PolyMatrix":
        with open(os.path.join(dir_path, f"{mat_id}.mxxm"), "rb") as f:
            return PolyMatrix.from_compact_bytes(params, f.read(), device)
