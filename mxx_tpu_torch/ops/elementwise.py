"""Elementwise Z_q ops on limb-leading int64 tensors ([L, ...]).

The port's counterpart of `mxx_tpu/ops/elementwise.py`. Per-limb constants
are in standard form, so `ew_mul_const` replaces `ew_mul_mont_const`.
"""

from __future__ import annotations

import torch

from ..utils.u32 import addmod, limb_bcast, mulmod, negmod, submod


def ew_add(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return addmod(a, b, limb_bcast(q, a.ndim))


def ew_sub(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return submod(a, b, limb_bcast(q, a.ndim))


def ew_neg(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return negmod(a, limb_bcast(q, a.ndim))


def ew_mul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact elementwise a*b mod q."""
    return mulmod(a, b, limb_bcast(q, max(a.ndim, b.ndim)))


def ew_mul_const(a: torch.Tensor, c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * c mod q where c is a per-limb constant [L] in standard form."""
    return mulmod(a, limb_bcast(c, a.ndim), limb_bcast(q, a.ndim))


def reduce_once(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Reduce values in [0, 2q) to [0, q)."""
    qb = limb_bcast(q, a.ndim)
    return torch.where(a >= qb, a - qb, a)
