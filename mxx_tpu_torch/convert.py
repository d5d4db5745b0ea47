"""Carry state across from the JAX package through numpy arrays.

The functions take and give numpy arrays (`np.asarray` of a jax array is
one), so this module imports neither jax nor `mxx_tpu`: the tests use it to
run the port on the JAX package's trapdoor, public matrix, keys, BGG+ public
keys, encodings and secrets, a Diamond injector's final checkpoints, Diamond
WE ciphertexts, the AKY24 FE keys and ciphertexts, a noise refresher's
material, packed and vec BGG+ wires, Diamond iO obfuscations and WEE25
public params. Artifact files need no bridge: both packages write the same
bytes (a GGH15 chain's trapdoors too, as compact bytes; matrices also as
packed bytes and `.mxxm`/`.mxxp` files; circuits as the serde JSON of
`circuit.serde`, whose LUT tables the caller registers again). Native GSW
ciphertexts are Python ints and cross as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from .bgg import BggEncoding, BggPublicKey
from .bgg.poly_encoding import BggPolyEncoding
from .bgg.vec import BGGEncodingVec, BGGPublicKeyVec
from .commit import Wee25PublicParams
from .func_enc import Aky24Ciphertext, Aky24FuncKey, Aky24MasterKey
from .input_injector import DiamondInjectorPreprocessOut
from .io_protocols import DiamondIOObf
from .io_protocols.prf_mask import PrfDebugArtifacts
from .matrix import PolyMatrix
from .ring.params import RingParams
from .noise_refresh.naive_vec import RefreshMaterialCts
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


def refresh_material_from_numpy(params: RingParams, material: dict, device="cuda") -> dict:
    """The dict `DiamondNoiseRefresher.preprocess` returns, made by the JAX
    package: `mask_value` is an int; `a_m`, `p_mask` and `p_decoder` are
    (residues, fmt) pairs; `digit_pks` and `p_digits` are lists of such pairs."""
    def mat(pair):
        return poly_matrix_from_numpy(params, *pair, device)

    return {
        "mask_value": int(material["mask_value"]),
        "a_m": mat(material["a_m"]),
        "digit_pks": [mat(m) for m in material["digit_pks"]],
        "p_mask": mat(material["p_mask"]),
        "p_digits": [mat(m) for m in material["p_digits"]],
        "p_decoder": mat(material["p_decoder"]),
    }


def poly_encoding_from_numpy(params: RingParams, vectors, pubkey_matrix, reveal_plaintext: bool,
                             plaintexts=None, device="cuda") -> BggPolyEncoding:
    """A packed encoding: its slot rows and its shared public key as
    (residues, fmt) pairs, and its slot plaintexts as a list of such pairs
    (None where they are hidden)."""
    pts = None
    if plaintexts is not None:
        pts = tuple(poly_from_numpy(params, a, fmt, device) for a, fmt in plaintexts)
    return BggPolyEncoding(
        poly_matrix_from_numpy(params, *vectors, device),
        public_key_from_numpy(params, *pubkey_matrix, reveal_plaintext, device),
        pts,
    )


def public_key_vec_from_numpy(params: RingParams, keys, device="cuda") -> BGGPublicKeyVec:
    """A vec of public keys from (residues, fmt, reveal_plaintext) per slot."""
    return BGGPublicKeyVec.new(
        [public_key_from_numpy(params, m, fmt, reveal, device) for m, fmt, reveal in keys]
    )


def encoding_vec_from_numpy(params: RingParams, encodings, device="cuda") -> BGGEncodingVec:
    """A vec of encodings, one (vector, pubkey matrix, reveal_plaintext,
    plaintext) tuple per slot as in `aky24_ciphertext_from_numpy`."""
    encs = []
    for vector, pk_matrix, reveal, plaintext in encodings:
        pk = public_key_from_numpy(params, *pk_matrix, reveal, device)
        pt, pt_fmt = plaintext if plaintext is not None else (None, None)
        encs.append(encoding_from_numpy(params, *vector, pk, pt, pt_fmt, device))
    return BGGEncodingVec.new(encs)


def diamond_io_obf_from_numpy(params: RingParams, hash_key: bytes, trapdoors, pub_matrices,
                              num_outputs: int, unit_ct_consts, seed_cts, prf_debug=None,
                              device="cuda") -> DiamondIOObf:
    """A Diamond iO obfuscation made by the JAX package: its hash key, the
    injector's final checkpoints (as in `preprocess_out_from_numpy`), its
    output count, unit-ciphertext constants and seed ciphertexts (Python
    ints), and its debug-replay artifacts as a dict of `prg_cts`,
    `refresh_material` (per round and branch an (errors, masks) pair),
    `final_mask_cts` and `original_seed_bits`, or None. With the artifact
    directory it was written to, `DiamondIO.eval` of the port evaluates it."""
    debug = None
    if prf_debug is not None:
        debug = PrfDebugArtifacts(
            prg_cts=list(prf_debug["prg_cts"]),
            refresh_material=[
                [RefreshMaterialCts(errors=list(e), masks=list(m)) for e, m in per_round]
                for per_round in prf_debug["refresh_material"]
            ],
            final_mask_cts=list(prf_debug["final_mask_cts"]),
            original_seed_bits=list(prf_debug["original_seed_bits"]),
        )
    top_u, bottom_u = unit_ct_consts
    consts = ((tuple(top_u), tuple(bottom_u)) if isinstance(top_u, (list, tuple))
              else (int(top_u), int(bottom_u)))
    return DiamondIOObf(
        bytes(hash_key),
        preprocess_out_from_numpy(params, trapdoors, pub_matrices, device),
        int(num_outputs), consts, list(seed_cts), debug,
    )


def wee25_public_params_from_numpy(params: RingParams, b, t_bottom, t_top, hash_key: bytes,
                                   device="cuda") -> Wee25PublicParams:
    """WEE25 public params made by the JAX package: B and T_bottom as
    (residues, fmt) pairs, and its T_top preimages as such pairs in block
    order (the values of its `t_top` dict by key), stacked by rows in EVAL
    form as the port keeps them."""
    blocks = [poly_matrix_from_numpy(params, *pair, device).to_eval() for pair in t_top]
    return Wee25PublicParams(
        poly_matrix_from_numpy(params, *b, device),
        poly_matrix_from_numpy(params, *t_bottom, device),
        blocks[0].concat_rows(blocks[1:]),
        bytes(hash_key),
    )


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """uint32[8] ChaCha20 key (the JAX package's key array) -> int64[8] key."""
    k = np.asarray(key)
    if k.shape != (8,):
        raise ValueError(f"a key has 8 words, got shape {k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)
