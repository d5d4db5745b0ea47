"""Exact Z_q polynomial-matrix multiply, per (limb, eval slot).

The port's counterpart of `mxx_tpu/ops/zq_matmul.py`. The JAX package splits
residues into int8 digit planes for the TPU's matrix unit; here the product
is a loop over the contraction index of int64 multiply, add and reduce:
the accumulator stays below q and each product below 2^62, so every step is
exact. (CUDA has no integer `torch.matmul`; an int8 digit-plane form on
`torch._int_mm` waits for a profile that shows the need.)

Shapes: a int64[..., L, r, k, n], b int64[..., L, k, c, n], both in EVAL
format, with the same leading batch dims (none for one product); result
int64[..., L, r, c, n].
"""

from __future__ import annotations

import torch


def zq_matmul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact (a @ b) mod q, batched per (limb, eval-slot) and leading dims."""
    *lead, L, r, k, n = a.shape
    c = b.shape[-2]
    if tuple(b.shape) != (*lead, L, k, c, n):
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    qb = q.reshape(L, 1, 1, 1)
    acc = torch.zeros((*lead, L, r, c, n), dtype=torch.int64, device=a.device)
    for j in range(k):
        acc += a[..., j, :].unsqueeze(-2) * b[..., j, :, :].unsqueeze(-3)
        acc.remainder_(qb)
    return acc
