"""Debug/test LUT evaluators over BGG wires.

The port's counterpart of `mxx_tpu/lookup/debug.py`. These evaluators make
LUT-heavy circuits evaluable in tests without the per-entry Gaussian
preimages of the production LWE evaluator, by building the output wires
directly from the (test-held) BGG secret:

- pubkey path: output pubkey = Hash(key, "A_LT_{gate}"), IDENTICAL to the
  production evaluator's output pubkey;
- encoding path: output encoding = s (A_LT - y G), the exact relation the
  production evaluator's c_b K_high + c_z K_low telescopes to, with zero
  lookup error.

Both have a `public_lookup_batch`, so the level-batched evaluator takes a
level's PubLut gates as one batch. NEVER use outside tests: they require the
secret.
"""

from __future__ import annotations

import torch

from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..ops.elementwise import ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import EVAL, Poly, residue_planes_from_ints
from ..sampler import Trapdoor
from .lwe import derive_a_lt_matrices_batch, derive_a_lt_matrix
from .public_lut import lut_input_values


def debug_trapdoor_preimage(params, trapdoor: Trapdoor, target: PolyMatrix) -> PolyMatrix:
    """Exact preimage without perturbation:
    A [R z; E z; z] = (G - AR - E + AR + E) z = target."""
    dec = target.decompose()
    r_part = trapdoor.r @ dec
    e_part = trapdoor.e @ dec
    return r_part.concat_rows([e_part, dec])


class RelationCheckingPltEvaluator:
    """Wraps any encoding-path PltEvaluator and checks the BGG relation of
    every lookup output against the given secret row (zero-error runs)."""

    def __init__(self, inner, secret_vec: PolyMatrix):
        self.inner = inner
        self.secret_vec = secret_vec

    def public_lookup(self, params, plt, one, input_enc, gate_id, lut_id):
        out = self.inner.public_lookup(params, plt, one, input_enc, gate_id, lut_id)
        if isinstance(out, BggEncoding) and out.plaintext is not None:
            d = self.secret_vec.ncol
            g = PolyMatrix.gadget_matrix(params, d, self.secret_vec.data.device)
            expected = self.secret_vec @ out.pubkey.matrix - (
                self.secret_vec @ g
            ).mul_poly_scalar(out.plaintext)
            if not out.vector == expected:
                raise AssertionError(f"debug: LUT output relation violated at gate {gate_id}")
        return out


class DebugBGGPubKeyPltEvaluator:
    """Pubkey-path debug evaluator: hash-derived A_LT, no artifact sampling."""

    def __init__(self, hash_key: bytes):
        self.hash_key = hash_key

    def public_lookup(self, params, plt, one, input_pk: BggPublicKey,
                      gate_id: int, lut_id: int, slot_idx=None) -> BggPublicKey:
        a_lt = derive_a_lt_matrix(params, input_pk.matrix.nrow, self.hash_key, gate_id, slot_idx,
                                  device=input_pk.matrix.data.device)
        return BggPublicKey(a_lt, True)

    def public_lookup_batch(self, params, items, slot_idxs=None) -> list[BggPublicKey]:
        """items = [(plt, input_pk, gate_id, lut_id)], `slot_idxs` one slot
        per item or None; equal to per-gate `public_lookup` (same A_LT
        streams)."""
        d = items[0][1].matrix.nrow
        if any(it[1].matrix.nrow != d for it in items):
            raise ValueError("a LUT batch takes input pubkeys with one row count")
        a_lts = derive_a_lt_matrices_batch(params, d, self.hash_key, [it[2] for it in items],
                                           device=items[0][1].matrix.data.device,
                                           slot_idxs=slot_idxs)
        return [BggPublicKey(a, True) for a in a_lts]

    def sample_aux_matrices(self, params):
        pass


def _lut_enc_vectors(a_data, y_res, s_data, g_data, q):
    """vec[b] = s @ (A_LT[b] - G * y[b]) for a whole LUT batch.

    a_data [L, B*d, m, n] (EVAL); y_res [L, B] (constant-poly residues);
    s_data [L, 1, d, n]; g_data [L, d, m, n]. Returns [B, L, 1, m, n]."""
    L, Bd, m, n = a_data.shape
    d = g_data.shape[1]
    B = Bd // d
    yb = y_res.repeat_interleave(d, dim=1)[:, :, None, None]  # [L, B*d, 1, 1]
    diff = ew_sub(a_data, ew_mul(g_data.repeat(1, B, 1, 1), yb, q), q)
    diff_b = diff.reshape(L, B, d, m, n).transpose(0, 1)  # [B, L, d, m, n]
    return zq_matmul(s_data.expand((B,) + tuple(s_data.shape)), diff_b, q)


class DebugBGGEncodingPltEvaluator:
    """Encoding-path debug evaluator: exact output from the test-held secret.

    `secret_vec` is the 1 x d BGG secret row s."""

    def __init__(self, hash_key: bytes, secret_vec: PolyMatrix):
        self.hash_key = hash_key
        self.secret_vec = secret_vec

    def public_lookup(self, params, plt, one, input_enc: BggEncoding,
                      gate_id: int, lut_id: int, slot_idx=None) -> BggEncoding:
        if input_enc.plaintext is None:
            raise ValueError("debug lookup input must reveal its plaintext")
        z = int(input_enc.plaintext.const_value())
        got = plt.get(params, z)
        if got is None:
            raise KeyError(f"{z} not found in LUT {lut_id} for gate {gate_id}")
        device = self.secret_vec.data.device
        y_poly = Poly.from_elem_to_constant(params, got[1], device)
        d = input_enc.pubkey.matrix.nrow
        a_lt = derive_a_lt_matrix(params, d, self.hash_key, gate_id, slot_idx, device=device)
        gadget = PolyMatrix.gadget_matrix(params, d, device)
        vector = self.secret_vec @ (a_lt - gadget.mul_poly_scalar(y_poly))
        return BggEncoding(vector, BggPublicKey(a_lt, True), y_poly)

    def public_lookup_batch(self, params, items, slot_idxs=None) -> list[BggEncoding]:
        """items = [(plt, input_enc, gate_id, lut_id)], `slot_idxs` one slot
        per item or None: one read of the inputs' constants, one A_LT batch,
        one batched G*y subtraction and secret-row product; equal to per-gate
        `public_lookup`. The outputs are views of the batch's result on the
        device."""
        device = self.secret_vec.data.device
        d = items[0][1].pubkey.matrix.nrow
        zs = lut_input_values(params, [it[1].plaintext for it in items])
        y_vals = []
        for (plt, _input_enc, gate_id, lut_id), z in zip(items, zs):
            got = plt.get(params, z)
            if got is None:
                raise KeyError(f"{z} not found in LUT {lut_id} for gate {gate_id}")
            y_vals.append(int(got[1].value))
        y_res = torch.from_numpy(residue_planes_from_ints(params, y_vals).astype("int64"))
        y_res = y_res.to(device)  # [L, B]
        L, B = y_res.shape
        ys = [Poly(y_res[:, i : i + 1].expand(L, params.n).contiguous(), EVAL, params)
              for i in range(B)]
        a_lts = derive_a_lt_matrices_batch(params, d, self.hash_key, [it[2] for it in items],
                                           device=device, slot_idxs=slot_idxs)
        a_data = torch.cat([a.data for a in a_lts], dim=1)  # [L, B*d, m, n]
        vec = _lut_enc_vectors(
            a_data, y_res, self.secret_vec.to_eval().data,
            PolyMatrix.gadget_matrix(params, d, device).data, params.tables(device).moduli,
        )  # [B, L, 1, m, n]
        return [
            BggEncoding(PolyMatrix(vec[i], EVAL, params), BggPublicKey(a_lts[i], True), ys[i])
            for i in range(B)
        ]
