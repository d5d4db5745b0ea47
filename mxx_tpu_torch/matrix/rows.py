"""Stacks of equal-shape polynomial matrices as one tensor.

A stack of W matrices of shape (r, c) is an int64 tensor [L, W, r, c, n] in
EVAL form. Real-mode Diamond iO treats thousands of wires alike (a rebase
and a refresh per PRG output wire, each a few products with G^{-1}); one op
over the stack replaces a few dozen small ops per wire. Every function gives,
matrix by matrix, the values of the `PolyMatrix` op it names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_mul_const
from ..ops.zq_matmul import zq_matmul
from ..ring.ntt import ntt_fwd_auto, ntt_inv_auto
from ..ring.poly import COEFF, EVAL, residues_from_int
from .poly_matrix import PolyMatrix


def stack(params, mats) -> torch.Tensor:
    """[L, W, r, c, n] EVAL data of equal-shape matrices (or [L, W, n] of
    polys), the COEFF ones transformed in one batch."""
    out = torch.stack([m.data for m in mats], dim=1)
    coeff = [i for i, m in enumerate(mats) if m.fmt != EVAL]
    if len(coeff) == len(mats):
        return ntt_fwd_auto(out, params)
    if coeff:
        idx = torch.tensor(coeff, device=out.device)
        out[:, idx] = ntt_fwd_auto(out[:, idx], params)
    return out


def unstack(params, rows: torch.Tensor, fmt: str = EVAL) -> list[PolyMatrix]:
    """The stack's matrices (views)."""
    return [PolyMatrix(rows[:, w], fmt, params) for w in range(rows.shape[1])]


def decompose(params, rows: torch.Tensor, fmt: str = EVAL) -> torch.Tensor:
    """G^{-1} of each matrix of a stack [L, W, r, c, n] (EVAL, or COEFF with
    `fmt`), in EVAL form: [W, L, r*k, c, n] (batch-leading, the layout
    `zq_matmul` takes)."""
    p = params
    L, W, r, c, n = rows.shape
    data = rows.reshape(L, W * r, c, n)
    if fmt == EVAL:
        data = ntt_inv_auto(data, p)
    t = p.tables(data.device)
    dec = digit_decompose(
        data, t.moduli, t.digit_masks,
        base_bits=p.base_bits, dpt=p.digits_per_tower, towers=p.crt_depth,
    )
    dec = ntt_fwd_auto(dec, p)
    return dec.reshape(L, W, r * p.modulus_digits, c, n).transpose(0, 1)


def matmul_left(params, left: PolyMatrix, rhs_batch: torch.Tensor) -> torch.Tensor:
    """left @ rhs[w] for a batch-leading EVAL stack rhs [W, L, k, c, n]:
    [L, W, r, c, n]."""
    a = left.to_eval().data
    W = rhs_batch.shape[0]
    q = params.tables(a.device).moduli
    return zq_matmul(a.expand((W,) + tuple(a.shape)), rhs_batch, q).transpose(0, 1)


def left_mul_decompose(params, left: PolyMatrix, rows: torch.Tensor) -> torch.Tensor:
    """left.mul_decompose(rows[w]) = left @ G^{-1}(rows[w]) for every w."""
    return matmul_left(params, left, decompose(params, rows))


def mul_decompose_const(params, rows: torch.Tensor, const: PolyMatrix) -> torch.Tensor:
    """rows[w].mul_decompose(const) = rows[w] @ G^{-1}(const) for every w."""
    dec = decompose(params, const.to_eval().data[:, None])[0]  # [L, r*k, c, n]
    W = rows.shape[1]
    q = params.tables(rows.device).moduli
    return zq_matmul(rows.transpose(0, 1), dec.expand((W,) + tuple(dec.shape)), q).transpose(0, 1)


def mul_int(params, rows: torch.Tensor, value: int) -> torch.Tensor:
    """Each matrix times the integer `value` (`PolyMatrix.mul_int_scalar`)."""
    c = torch.from_numpy(residues_from_int(params, value).astype(np.int64)).to(rows.device)
    return ew_mul_const(rows, c, params.tables(rows.device).moduli)


def modulus_switch(params, rows: torch.Tensor, new_modulus: int) -> torch.Tensor:
    """`PolyMatrix.modulus_switch` of each matrix: a COEFF stack. The switch
    rounds coefficient by coefficient, so the stack switches as one matrix."""
    L, W, r, c, n = rows.shape
    flat = PolyMatrix(rows.reshape(L, W * r, c, n), EVAL, params)
    out = flat.modulus_switch(new_modulus)
    assert out.fmt == COEFF
    return out.data.reshape(L, W, r, c, n)
