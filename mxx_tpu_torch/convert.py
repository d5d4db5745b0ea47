"""Carry state across from the JAX package through numpy arrays.

The functions take and give numpy arrays (`np.asarray` of a jax array is
one), so this module imports neither jax nor `mxx_tpu`: the tests use it to
run the port on the JAX package's trapdoor, public matrix, keys, BGG+ public
keys, encodings and secrets, a Diamond injector's final checkpoints, Diamond
WE ciphertexts and the AKY24 FE keys and ciphertexts. Artifact files need no
bridge: both packages write the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .bgg import BggEncoding, BggPublicKey
from .func_enc import Aky24Ciphertext, Aky24FuncKey, Aky24MasterKey
from .input_injector import DiamondInjectorPreprocessOut
from .matrix import PolyMatrix
from .ring.params import RingParams
from .ring.poly import Poly
from .sampler.trapdoor import Trapdoor
from .we import DiamondWECiphertext


def poly_matrix_from_numpy(params: RingParams, arr, fmt: str, device="cuda") -> PolyMatrix:
    """uint32[L, r, c, n] residues (a JAX package PolyMatrix's data) -> PolyMatrix."""
    a = np.asarray(arr)
    if a.ndim != 4 or a.shape[0] != params.crt_depth or a.shape[3] != params.n:
        raise ValueError(f"shape {a.shape} is not [L={params.crt_depth}, r, c, n={params.n}]")
    return PolyMatrix(torch.from_numpy(a.astype(np.int64)).to(device), fmt, params)


def to_numpy(value: PolyMatrix | Poly) -> np.ndarray:
    """PolyMatrix or Poly -> uint32 residues ([L, r, c, n] or [L, n]), the
    JAX package's layout."""
    return value.data.cpu().numpy().astype(np.uint32)


def poly_from_numpy(params: RingParams, arr, fmt: str, device="cuda") -> Poly:
    """uint32[L, n] residues (a JAX package Poly's data) -> Poly."""
    a = np.asarray(arr)
    if a.shape != (params.crt_depth, params.n):
        raise ValueError(f"shape {a.shape} is not [L={params.crt_depth}, n={params.n}]")
    return Poly(torch.from_numpy(a.astype(np.int64)).to(device), fmt, params)


def secrets_from_numpy(params: RingParams, arrs, fmt: str, device="cuda") -> list[Poly]:
    """The secret row of a BGG+ encoding sampler, one uint32[L, n] per poly."""
    return [poly_from_numpy(params, a, fmt, device) for a in arrs]


def public_key_from_numpy(params: RingParams, matrix, fmt: str, reveal_plaintext: bool,
                          device="cuda") -> BggPublicKey:
    """BGG+ public key from its matrix residues uint32[L, d, m, n]."""
    return BggPublicKey(poly_matrix_from_numpy(params, matrix, fmt, device), reveal_plaintext)


def encoding_from_numpy(params: RingParams, vector, vector_fmt: str, pubkey: BggPublicKey,
                        plaintext=None, plaintext_fmt: str | None = None,
                        device="cuda") -> BggEncoding:
    """BGG+ encoding from its vector residues uint32[L, 1, m, n], its public
    key and, where it is known, its plaintext residues uint32[L, n]."""
    pt = None if plaintext is None else poly_from_numpy(params, plaintext, plaintext_fmt, device)
    return BggEncoding(poly_matrix_from_numpy(params, vector, vector_fmt, device), pubkey, pt)


def trapdoor_from_numpy(params: RingParams, r, e, fmt: str, device="cuda") -> Trapdoor:
    """Trapdoor from the residues of R and E (both in format `fmt`)."""
    return Trapdoor(
        r=poly_matrix_from_numpy(params, r, fmt, device),
        e=poly_matrix_from_numpy(params, e, fmt, device),
    )


def preprocess_out_from_numpy(params: RingParams, trapdoors, pub_matrices,
                              device="cuda") -> DiamondInjectorPreprocessOut:
    """A Diamond injector's final checkpoints: `trapdoors` as (R, E, fmt)
    triples and `pub_matrices` as (residues, fmt) pairs, one per final state."""
    return DiamondInjectorPreprocessOut(
        [trapdoor_from_numpy(params, r, e, fmt, device) for r, e, fmt in trapdoors],
        [poly_matrix_from_numpy(params, m, fmt, device) for m, fmt in pub_matrices],
    )


def diamond_we_ciphertext_from_numpy(params: RingParams, circuit, instance, hash_key: bytes,
                                     trapdoors, pub_matrices,
                                     device="cuda") -> DiamondWECiphertext:
    """A Diamond WE ciphertext: the port's copy of its circuit, the instance
    bits, the hash key and the injector's final checkpoints (as in
    `preprocess_out_from_numpy`). Its artifact files need no bridge."""
    return DiamondWECiphertext(
        circuit, list(instance), bytes(hash_key),
        preprocess_out_from_numpy(params, trapdoors, pub_matrices, device),
    )


def aky24_master_key_from_numpy(params: RingParams, secrets, trapdoor, b_matrix,
                                device="cuda") -> Aky24MasterKey:
    """AKY24 master key: `secrets` as (residues, fmt) pairs, the trapdoor as
    an (R, E, fmt) triple, B as a (residues, fmt) pair."""
    return Aky24MasterKey(
        [poly_from_numpy(params, a, fmt, device) for a, fmt in secrets],
        trapdoor_from_numpy(params, *trapdoor, device),
        poly_matrix_from_numpy(params, *b_matrix, device),
    )


def aky24_ciphertext_from_numpy(params: RingParams, encodings, c_b,
                                device="cuda") -> Aky24Ciphertext:
    """AKY24 ciphertext: `encodings` as (vector, pubkey matrix,
    reveal_plaintext, plaintext) tuples, each matrix or poly a (residues,
    fmt) pair and the plaintext None where it is hidden; c_b a pair."""
    encs = []
    for vector, pk_matrix, reveal, plaintext in encodings:
        pk = public_key_from_numpy(params, *pk_matrix, reveal, device)
        pt, pt_fmt = plaintext if plaintext is not None else (None, None)
        encs.append(encoding_from_numpy(params, *vector, pk, pt, pt_fmt, device))
    return Aky24Ciphertext(encs, poly_matrix_from_numpy(params, *c_b, device))


def aky24_func_key_from_numpy(params: RingParams, k_f, fmt: str,
                              device="cuda") -> Aky24FuncKey:
    """AKY24 function key K_f from its residues uint32[L, rows, 1, n]."""
    return Aky24FuncKey(poly_matrix_from_numpy(params, k_f, fmt, device))


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """uint32[8] ChaCha20 key (the JAX package's key array) -> int64[8] key."""
    k = np.asarray(key)
    if k.shape != (8,):
        raise ValueError(f"a key has 8 words, got shape {k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)
