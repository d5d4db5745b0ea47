"""Core sampling functions: keyed ChaCha20 PRNG -> int64 residue planes.

The port's counterpart of `mxx_tpu/sampler/core.py`, bit for bit on every
integer draw:

- Keys come from a 256-bit key + tag via SHA-256 (full digest kept).
- Uniform mod q_t reduces a 96-bit draw mod q_t (statistical distance
  < 2^-65 per sample), a fixed trip count instead of rejection.
- Discrete Gaussians: exact CDF inversion over a u64 threshold table for
  sigma <= 300 (tail 5e-32), a rounded continuous Gaussian above.
"""

from __future__ import annotations

import functools
import hashlib
import math
import os

import numpy as np
import torch

from . import chacha

KARNEY_THRESHOLD = 300.0
_GAUSS_TABLE_ACC = 5e-32
_SIGN = -(1 << 63)  # int64 with only the top bit set


def derive_key_bytes(key: bytes, tag: bytes | str, domain: bytes = b"") -> bytes:
    """Host-side digest for `derive_key`."""
    if isinstance(tag, str):
        tag = tag.encode()
    return hashlib.sha256(b"mxx_tpu/v1" + bytes(key) + b"|" + tag + b"|" + domain).digest()


def derive_key(key: bytes, tag: bytes | str, domain: bytes = b"", device="cuda") -> torch.Tensor:
    """Derive a PRNG key from a 32-byte key + tag (+ domain separator); the
    full SHA-256 digest becomes a 256-bit ChaCha20 key."""
    return chacha.key_from_bytes(derive_key_bytes(key, tag, domain), device)


def fresh_key(seed: int | bytes | None = None, device="cuda") -> torch.Tensor:
    """256-bit-keyspace key: from OS entropy when seed is None, else
    deterministically from the seed (tests / reproducible artifacts)."""
    if seed is None:
        material = os.urandom(32)
    elif isinstance(seed, bytes):
        material = hashlib.sha256(b"mxx_tpu/fresh" + seed).digest()
    else:
        material = hashlib.sha256(
            b"mxx_tpu/fresh" + int(seed).to_bytes(16, "little", signed=True)
        ).digest()
    return chacha.key_from_bytes(material, device)


@functools.lru_cache(maxsize=64)
def gauss_table(sigma: float) -> tuple[np.ndarray, int]:
    """u64 CDF thresholds for the discrete Gaussian D_{Z,sigma}, tail-cut at
    ~12 sigma (acc 5e-32)."""
    m = math.sqrt(-2.0 * math.log(_GAUSS_TABLE_ACC))
    fin = max(1, math.ceil(sigma * m))
    xs = np.arange(-fin, fin + 1, dtype=np.float64)
    logp = -(xs * xs) / (2.0 * sigma * sigma)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    cum = np.cumsum(p)
    thresholds = np.array([min(int(c * 2**64), 2**64 - 1) for c in cum], dtype=np.uint64)
    return thresholds, fin


def _reduce96(bits: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """The 96-bit value of words bits[0], bits[1], bits[2] (most significant
    first) mod q, one word at a time."""
    r = bits[0] % qb
    r = ((r << 32) | bits[1]) % qb
    return ((r << 32) | bits[2]) % qb


def uniform_residues(key: torch.Tensor, shape: tuple, q: torch.Tensor) -> torch.Tensor:
    """Uniform in [0, q_t) per limb: returns int64[L, *shape]."""
    L = q.shape[0]
    bits = chacha.random_bits(key, (3, L) + shape)
    return _reduce96(bits, q.reshape((L,) + (1,) * len(shape)))


def uniform_residues_batch(keys: torch.Tensor, shape: tuple, q: torch.Tensor) -> torch.Tensor:
    """Per-lane `uniform_residues`: keys int64[nb, 8] -> int64[nb, L, *shape],
    row i bit-identical to `uniform_residues(keys[i], shape, q)`."""
    L = q.shape[0]
    bits = chacha.random_bits_batch(keys, (3, L) + tuple(shape))  # [nb, 3, L, *shape]
    return _reduce96(bits.transpose(0, 1), q.reshape((1, L) + (1,) * len(shape)))


def _int_to_residues(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Signed int64 values [*shape] -> residues [L, *shape] in [0, q)."""
    L = q.shape[0]
    return v[None] % q.reshape((L,) + (1,) * v.ndim)


def bit_residues(key: torch.Tensor, shape: tuple, q: torch.Tensor) -> torch.Tensor:
    return _int_to_residues(chacha.random_bits(key, shape) & 1, q)


def ternary_residues(key: torch.Tensor, shape: tuple, q: torch.Tensor) -> torch.Tensor:
    # unbiased via 2^32 mod 3 == 1: rejection-free masked draw
    return _int_to_residues(chacha.random_bits(key, shape) % 3 - 1, q)


def _table_ints(key: torch.Tensor, shape: tuple, thresholds: np.ndarray, tail: int) -> torch.Tensor:
    """CDF inversion of uint64 draws against uint64 thresholds. int64 holds
    neither, so both go through the order-preserving map x -> x XOR 2^63 to
    signed before the search."""
    u = chacha.random_bits(key, shape, "uint64") ^ _SIGN
    thr = torch.from_numpy((thresholds ^ np.uint64(1 << 63)).view(np.int64)).to(u.device)
    return torch.searchsorted(thr, u, right=True) - tail


def gauss_residues_table(key: torch.Tensor, shape: tuple, q: torch.Tensor,
                         thresholds: np.ndarray, tail: int) -> torch.Tensor:
    return _int_to_residues(_table_ints(key, shape, thresholds, tail), q)


def gauss_residues_rounded(key: torch.Tensor, shape: tuple, q: torch.Tensor,
                           sigma: float) -> torch.Tensor:
    x = chacha.normal(key, shape, torch.float64) * sigma
    return _int_to_residues(torch.round(x).to(torch.int64), q)


def gauss_residues(key: torch.Tensor, shape: tuple, q: torch.Tensor, sigma: float) -> torch.Tensor:
    if sigma <= KARNEY_THRESHOLD:
        thresholds, tail = gauss_table(float(sigma))
        return gauss_residues_table(key, shape, q, thresholds, tail)
    return gauss_residues_rounded(key, shape, q, float(sigma))
