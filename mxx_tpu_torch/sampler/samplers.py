"""Matrix samplers over the keyed PRNG core.

The port's counterpart of `mxx_tpu/sampler/samplers.py`, bit for bit:

- `HashSampler`: deterministic matrices from (key, tag) with exact column
  windows: column j of a matrix is drawn under `fold_in(base_key, j)`, so any
  window of columns regenerates without the others.
- `UniformSampler`: fresh randomness from a held splitting key.

The JAX package's `vmap`s and `jit`s over keys and columns become one flat
batch of (key, column) lanes here.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..matrix import PolyMatrix
from ..ring.ntt import ntt_fwd_auto
from ..ring.params import RingParams
from ..ring.poly import COEFF, EVAL, Poly
from . import chacha, core
from .dist import BitDist, DistType, FinRingDist, GaussDist, TernaryDist


def _dist_domain(dist: DistType) -> bytes:
    if isinstance(dist, FinRingDist):
        return b"finring"
    if isinstance(dist, GaussDist):
        return b"gauss" + struct.pack("<d", dist.sigma)
    if isinstance(dist, BitDist):
        return b"bit"
    if isinstance(dist, TernaryDist):
        return b"ternary"
    raise TypeError(dist)


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


def _lane_planes(col_keys: torch.Tensor, cols: torch.Tensor, dist: DistType, nrow: int,
                 n: int, q: torch.Tensor) -> torch.Tensor:
    """Residue planes int64[lanes, L, nrow, n] of one matrix column per lane:
    lane i is column cols[i] under the base key col_keys[i]."""
    keys = chacha.fold_in_batch(col_keys, cols)
    L = q.shape[0]
    if isinstance(dist, FinRingDist):
        return core.uniform_residues_batch(keys, (nrow, n), q)
    if isinstance(dist, (BitDist, TernaryDist)):
        u = chacha.random_bits_batch(keys, (nrow, n))
        v = u & 1 if isinstance(dist, BitDist) else u % 3 - 1
        return v[:, None] % q.reshape(1, L, 1, 1)
    # Gaussian columns draw one lane at a time, as the JAX package's vmap of
    # the single-key sampler does
    return torch.stack([_sample_residues(k, dist, (nrow, n), q) for k in keys])


class HashSampler:
    """Deterministic keyed sampler with exact column windows."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def sample_hash(self, params: RingParams, key: bytes, tag, nrow: int, ncol: int,
                    dist: DistType) -> PolyMatrix:
        return self.sample_hash_columns(params, key, tag, nrow, ncol, 0, ncol, dist)

    def sample_hash_columns(self, params: RingParams, key: bytes, tag, nrow: int,
                            total_ncol: int, col_start: int, col_len: int,
                            dist: DistType) -> PolyMatrix:
        """Columns [col_start, col_start + col_len) of the nrow x total_ncol
        matrix of (key, tag), equal to that window of `sample_hash`."""
        if col_start < 0 or col_start + col_len > total_ncol:
            raise ValueError("column window out of bounds")
        base = core.derive_key(key, tag, _dist_domain(dist), self.device)
        cols = torch.arange(col_start, col_start + col_len, dtype=torch.int64,
                            device=self.device)
        q = params.tables(self.device).moduli
        planes = _lane_planes(base.expand(col_len, 8), cols, dist, nrow, params.n, q)
        return PolyMatrix(planes.permute(1, 2, 0, 3).contiguous(), COEFF, params)

    def sample_hash_batch(self, params: RingParams, key: bytes, tags: list, nrow: int,
                          ncol: int, dist: DistType, eval_form: bool = False) -> list[PolyMatrix]:
        """`sample_hash` for many tags in one batch of (tag, column) lanes,
        bit-identical to per-tag calls; with `eval_form` the matrices come back
        transformed to EVAL form by one batched NTT."""
        domain = _dist_domain(dist)
        base = np.stack([np.frombuffer(core.derive_key_bytes(key, tag, domain), dtype="<u4")
                         for tag in tags]).astype(np.int64)
        B = len(tags)
        keys = torch.from_numpy(base).to(self.device).repeat_interleave(ncol, dim=0)
        cols = torch.arange(ncol, dtype=torch.int64, device=self.device).repeat(B)
        q = params.tables(self.device).moduli
        L, n = params.crt_depth, params.n
        planes = _lane_planes(keys, cols, dist, nrow, n, q)  # [B * ncol, L, nrow, n]
        data = planes.reshape(B, ncol, L, nrow, n).permute(2, 0, 3, 1, 4).contiguous()
        fmt = COEFF
        if eval_form:
            data = ntt_fwd_auto(data, params)
            fmt = EVAL
        return [PolyMatrix(data[:, i], fmt, params) for i in range(B)]


class UniformSampler:
    """Fresh-randomness sampler; the key is split on every call."""

    def __init__(self, seed: int | None = None, device="cuda"):
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
