"""Batched constant lifts: many `one.large_scalar_mul(params, [c])` at once.

The port's counterpart of `mxx_tpu/bgg/lift.py`. The Diamond PRF pipeline
lifts every public Ring-GSW ciphertext component value onto a BGG wire by
scalar-multiplying the one wire (reference diamond_io.rs:330-388 / utils.rs
native_ciphertexts_to_public_key_wires): tens of thousands of lifts of the
SAME input wire with different integer constants,

    A_b = A_one @ G^{-1}(c_b * G)    for a whole chunk of constants c_b.

Written for the card rather than line by line. A constant c is a constant
polynomial, so c * G, its coefficient form, its digits and their evaluation
form are all constant polynomials: G^{-1}(c * G) has one small integer per
entry, the same in every evaluation slot. The chunk's digits are therefore
taken on a [L, B, d*k, m] tensor with no transform, and reach the exact
matmul as a broadcast view over the n slots: the [L, B*d*k, m, n] operand of
the JAX function (134 MB per constant at n=2^13, L=8, d=1) is never made.
What is made is the result, so the chunk is sized from the result's bytes
against `config.lut_bytes_limit()`, the bound the port already puts on one
buffer. There is no padding to a power of two (nothing is compiled per
shape) and nothing is copied to the host: the wires returned are slices of
the chunk's tensors on the device of `one_wire`.

Results are bit-identical to per-call `large_scalar_mul` (every step is
exact integer arithmetic mod q) and to the JAX function.
"""

from __future__ import annotations

import torch

from .. import config
from ..matrix import PolyMatrix
from ..ops.decompose import digit_decompose
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import EVAL, Poly, residue_planes_from_ints
from .encoding import BggEncoding
from .public_key import BggPublicKey


def lift_chunk_size(params, d: int, with_vector: bool) -> int:
    """Constants per chunk: the chunk's results ([B, L, d, d*k, n] for the
    public keys, [B, L, 1, d*k, n] more for encodings, int64) stay within
    `config.lut_bytes_limit()`; at least one."""
    rows = d + (1 if with_vector else 0)
    per_value = params.crt_depth * rows * d * params.modulus_digits * params.n * 8
    return max(1, config.lut_bytes_limit() // per_value)


def _const_digits(params, values, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Residues s [L, B] of the constants, and the digits of G^{-1}(c_b * G)
    as [B, L, d*k, m]: one integer per entry, the value its constant
    polynomial has in every slot."""
    t = params.tables(device)
    s = torch.from_numpy(residue_planes_from_ints(params, values).astype("int64")).to(device)
    gadget = PolyMatrix.gadget_matrix(params, d, device).data[..., 0]  # [L, d, m]
    L, _, m = gadget.shape
    B = s.shape[1]
    q = t.moduli.reshape(L, 1, 1, 1)
    sg = (gadget[:, None] * s[:, :, None, None]) % q  # [L, B, d, m]
    dec = digit_decompose(
        sg.reshape(L, B * d, m, 1), t.moduli, t.digit_masks,
        base_bits=params.base_bits, dpt=params.digits_per_tower, towers=params.crt_depth,
    )  # [L, B*d*k, m, 1]
    k = params.modulus_digits
    return s, dec.reshape(L, B, d * k, m).permute(1, 0, 2, 3)


def _lift_chunk(params, one_matrix, one_vector, values):
    """(s_eval [B, L, n], public keys [B, L, d, m, n], vectors or None)."""
    device = one_matrix.device
    L, d, _, n = one_matrix.shape
    s, dec = _const_digits(params, values, d, device)
    B = len(values)
    dec_b = dec[..., None].expand(*dec.shape, n)
    q = params.tables(device).moduli
    out_pk = zq_matmul(one_matrix[None].expand(B, *one_matrix.shape), dec_b, q)
    out_vec = None
    if one_vector is not None:
        out_vec = zq_matmul(one_vector[None].expand(B, *one_vector.shape), dec_b, q)
    s_eval = s.T[:, :, None].expand(B, L, n).contiguous()
    return s_eval, out_pk, out_vec


def lift_constants_batched(params, one_wire, values: list[int]):
    """Lift integer constants onto BGG wires via the one wire: returns
    BggPublicKey wires if `one_wire` is a BggPublicKey, BggEncoding wires
    (plaintext = the constant) if it is a BggEncoding."""
    is_enc = isinstance(one_wire, BggEncoding)
    pubkey = one_wire.pubkey if is_enc else one_wire
    one_matrix = pubkey.matrix.to_eval().data
    one_vector = one_wire.vector.to_eval().data if is_enc else None
    chunk_size = lift_chunk_size(params, one_matrix.shape[1], is_enc)
    outs = []
    for start in range(0, len(values), chunk_size):
        chunk = [int(v) for v in values[start : start + chunk_size]]
        s_eval, out_pk, out_vec = _lift_chunk(params, one_matrix, one_vector, chunk)
        for i in range(len(chunk)):
            pk = BggPublicKey(PolyMatrix(out_pk[i], EVAL, params), pubkey.reveal_plaintext)
            if is_enc:
                pt = Poly(s_eval[i], EVAL, params)
                outs.append(BggEncoding(PolyMatrix(out_vec[i], EVAL, params), pk, pt))
            else:
                outs.append(pk)
    return outs
