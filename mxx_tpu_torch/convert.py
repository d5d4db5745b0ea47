"""Carry state across from the JAX package through numpy arrays.

The functions take and give numpy arrays (`np.asarray` of a jax array is
one), so this module imports neither jax nor `mxx_tpu`: the tests use it to
run the port on the JAX package's trapdoor, public matrix and keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrix import PolyMatrix
from .ring.params import RingParams
from .sampler.trapdoor import Trapdoor


def poly_matrix_from_numpy(params: RingParams, arr, fmt: str, device="cpu") -> PolyMatrix:
    """uint32[L, r, c, n] residues (a JAX package PolyMatrix's data) -> PolyMatrix."""
    a = np.asarray(arr)
    if a.ndim != 4 or a.shape[0] != params.crt_depth or a.shape[3] != params.n:
        raise ValueError(f"shape {a.shape} is not [L={params.crt_depth}, r, c, n={params.n}]")
    return PolyMatrix(torch.from_numpy(a.astype(np.int64)).to(device), fmt, params)


def to_numpy(mat: PolyMatrix) -> np.ndarray:
    """PolyMatrix -> uint32[L, r, c, n] residues, the JAX package's layout."""
    return mat.data.cpu().numpy().astype(np.uint32)


def trapdoor_from_numpy(params: RingParams, r, e, fmt: str, device="cpu") -> Trapdoor:
    """Trapdoor from the residues of R and E (both in format `fmt`)."""
    return Trapdoor(
        r=poly_matrix_from_numpy(params, r, fmt, device),
        e=poly_matrix_from_numpy(params, e, fmt, device),
    )


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """uint32[8] ChaCha20 key (the JAX package's key array) -> int64[8] key."""
    k = np.asarray(key)
    if k.shape != (8,):
        raise ValueError(f"a key has 8 words, got shape {k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)
