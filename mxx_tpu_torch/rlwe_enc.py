"""RLWE encryption helper: b = t*a + e + m * floor(q/2) (the port's
counterpart of `mxx_tpu/rlwe_enc.py`); everything on the device of `a`."""

from __future__ import annotations

from .matrix import PolyMatrix
from .ring.element import FinRingElem
from .ring.poly import Poly
from .sampler import GaussDist, UniformSampler


def rlwe_encrypt(
    params, sampler_uniform: UniformSampler, t: PolyMatrix, a: PolyMatrix, m: PolyMatrix,
    sigma: float,
) -> PolyMatrix:
    if not (m.shape == (1, 1) and t.shape == (1, 1) and a.shape == (1, 1)):
        raise ValueError(f"rlwe_encrypt takes 1x1 matrices, got t {t.shape}, a {a.shape}, "
                         f"m {m.shape}")
    e = sampler_uniform.sample_uniform(params, 1, 1, GaussDist(sigma))
    scale = Poly.from_elem_to_constant(params, FinRingElem.half_q(params.modulus),
                                       a.data.device)
    return t @ a + e + m.mul_poly_scalar(scale)
