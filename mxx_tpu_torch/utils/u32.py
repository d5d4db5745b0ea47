"""Modular arithmetic on int64 residue tensors.

The port's counterpart of `mxx_tpu/utils/u32.py`. Residues are int64 in
[0, q) with q < 2^31, so a product of two residues is below 2^62 and
`(a * b) % q` is exact; PyTorch has no uint32 add, shift or compare, and the
JAX package's 16-bit `mulhi` emulation has no reason to exist here.
`montmul` is kept for tables stored in Montgomery form (R = 2^32).

Convention: data tensors carry a leading limb axis; per-limb constants are
int64 tensors of shape [L] and broadcast with `limb_bcast`.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def limb_bcast(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-limb constant [L] for broadcasting against [L, ...]."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1))


def addmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q, for a, b in [0, q)."""
    r = a + b
    return torch.where(r >= q, r - q, r)


def submod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q, for a, b in [0, q)."""
    r = a - b
    return torch.where(r < 0, r + q, r)


def negmod(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def mulmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * b mod q for standard-form operands in [0, q), q < 2^31."""
    return a * b % q


def montmul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, qinv_neg: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-32 mod q.

    qinv_neg = -q^{-1} mod 2^32. Requires a, b in [0, q), q odd, q < 2^31.
    t + m q can reach 2^63, so the sum is formed from its high words as the
    JAX version does: t_lo + (m q)_lo = 0 mod 2^32, with a carry iff t_lo != 0.
    """
    t = a * b
    t_lo = t & _M32
    # m = t_lo * qinv_neg mod 2^32, in two 16-bit halves of qinv_neg so that
    # no int64 product overflows
    m = (t_lo * (qinv_neg & 0xFFFF) + (((t_lo * (qinv_neg >> 16)) & 0xFFFF) << 16)) & _M32
    r = (t >> 32) + ((m * q) >> 32) + (t_lo != 0).to(t.dtype)
    return torch.where(r >= q, r - q, r)
