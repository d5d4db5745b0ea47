"""CRT scale-and-round over a sharded limb axis.

The port's counterpart of `mxx_tpu/parallel/crt_collective.py`. Decode and
modulus switch need x = sum_t r_t e_t (mod q) from residues whose limbs lie
on different devices; x itself does not fit a machine word, so the
collective computes what protocols consume:

    v = round(x * P / q) mod P          (scale-and-round to a small modulus)

With e_t * P / q = I_t + f_t (integer and fractional part, host tables of
`RingParams.ms_tables`):

    v = ( sum_t [r_t * I_t mod P]  +  round(sum_t r_t * f_t) ) mod P

Each limb shard computes its limbs' integer terms (exact, int64) and
fractional terms (float64) on its own device. The integer partials are
added across shards in shard order, like the JAX package's `psum`. The
fractional sum is the one place where order changes the result: float64
addition does not associate, so a coefficient whose fraction lies within
~2^-20 of 1/2 can round either way. Here the accumulator passes from each
limb shard to the next and adds that shard's terms in limb order, so the
sum is `PolyMatrix.modulus_switch`'s limb-by-limb sum, bit for bit, for any
mesh shape: both run `matrix.poly_matrix.switch_terms` and `switch_round`,
`modulus_switch` as the case of one limb shard. The price is that the
fraction sums of a multi-card mesh run one shard after another, with nl
transfers of the float64 coefficient array, where the JAX package adds
independent per-shard partials in parallel (and can round such a
coefficient the other way).
"""

from __future__ import annotations

import torch

from ..matrix.poly_matrix import switch_round, switch_terms
from .mesh import LIMB_AXIS, Mesh


def crt_switch_sharded(params, data: torch.Tensor, new_modulus: int, mesh: Mesh, *,
                       limb_axis: str = LIMB_AXIS) -> torch.Tensor:
    """round(x * P / q) mod P per coefficient, with the limb axis of `data`
    split over `mesh`'s `limb_axis`.

    data: int64[L, ...] COEFF-form residues (any trailing shape). Returns
    int64[...] (limb axis reduced away) on the device of the mesh's first
    shard; the result is the same for every shard (replicated)."""
    if not 1 < new_modulus < (1 << 32):
        raise ValueError(f"the collective switch targets a modulus in (1, 2^32), got "
                         f"{new_modulus}")
    L = params.crt_depth
    nl = mesh.shape[limb_axis]
    if data.shape[0] != L or L % nl:
        raise ValueError(f"{L} limbs of data {tuple(data.shape)} do not split over {nl} "
                         f"limb shards")
    ints, fracs = params.ms_tables(new_modulus)
    per = L // nl
    # a limb shard's work is the same at every col index, so it runs once, at
    # col index 0. The integer partials are added on the first shard's device
    # in shard order; the float64 accumulator goes from shard to shard.
    home = mesh.device()
    hi = torch.zeros(data.shape[1:], dtype=torch.int64, device=home)
    fr = torch.zeros(data.shape[1:], dtype=torch.float64, device=home)
    for i in range(nl):
        lo, up = i * per, (i + 1) * per
        hi_i, fr = switch_terms(data[lo:up].to(mesh.device(**{limb_axis: i})), ints[lo:up],
                                fracs[lo:up], new_modulus, fr)
        hi = hi + hi_i.to(home)
    return switch_round(hi, fr.to(home), new_modulus)
