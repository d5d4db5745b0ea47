"""Per-tower base-2^b digit decomposition (G^{-1}).

The port's counterpart of `mxx_tpu/ops/decompose.py`. Digits are ordered
tower-major: output row block index = tower * digits_per_tower + j, matching
the gadget-vector residues in `RingParams.np_gadget_res`.
"""

from __future__ import annotations

import torch


def digit_decompose(data: torch.Tensor, q: torch.Tensor, digit_masks: torch.Tensor, *,
                    base_bits: int, dpt: int, towers: int) -> torch.Tensor:
    """data: int64[L, r, c, n] in COEFF form -> int64[L, r*k', c, n].

    k' = towers * dpt. For the full G^{-1}, towers == L; for the "small"
    per-tower variant (entries with small norm), towers == 1.
    """
    L, r, c, n = data.shape
    digits = []
    for t in range(towers):
        x = data[t]
        for j in range(dpt):
            digits.append((x >> (j * base_bits)) & digit_masks[j])
    dig = torch.stack(digits)  # [k', r, c, n], values < 2^crt_bits < 2*q_s
    qb = q[:, None, None, None, None]
    red = torch.where(dig[None] >= qb, dig[None] - qb, dig[None])  # [L, k', r, c, n]
    return red.transpose(1, 2).reshape(L, r * towers * dpt, c, n)
