"""Matrix samplers over the keyed PRNG core.

The port's counterpart of `mxx_tpu/sampler/samplers.py`: `UniformSampler`,
fresh randomness from a held splitting key. `HashSampler` is not ported yet.
"""

from __future__ import annotations

import torch

from ..matrix import PolyMatrix
from ..ring.params import RingParams
from ..ring.poly import COEFF, Poly
from . import chacha, core
from .dist import BitDist, DistType, FinRingDist, GaussDist, TernaryDist


def _sample_residues(key: torch.Tensor, dist: DistType, shape: tuple, q: torch.Tensor) -> torch.Tensor:
    """Draw residue planes int64[L, *shape] for the given distribution."""
    if isinstance(dist, FinRingDist):
        return core.uniform_residues(key, shape, q)
    if isinstance(dist, GaussDist):
        return core.gauss_residues(key, shape, q, dist.sigma)
    if isinstance(dist, BitDist):
        return core.bit_residues(key, shape, q)
    if isinstance(dist, TernaryDist):
        return core.ternary_residues(key, shape, q)
    raise TypeError(dist)


class UniformSampler:
    """Fresh-randomness sampler; the key is split on every call."""

    def __init__(self, seed: int | None = None, device="cpu"):
        self.device = torch.device(device)
        self._key = core.fresh_key(seed, self.device)

    def _next_key(self) -> torch.Tensor:
        self._key, sub = chacha.split2(self._key)
        return sub

    def sample_uniform(self, params: RingParams, nrow: int, ncol: int, dist: DistType) -> PolyMatrix:
        q = params.tables(self.device).moduli
        planes = _sample_residues(self._next_key(), dist, (nrow, ncol, params.n), q)
        return PolyMatrix(planes, COEFF, params)

    def sample_poly(self, params: RingParams, dist: DistType) -> Poly:
        return self.sample_uniform(params, 1, 1, dist).entry(0, 0)
