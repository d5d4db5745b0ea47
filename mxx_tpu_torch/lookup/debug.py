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
level's PubLut gates as one batch, and a `public_lookup_rows`, the same over
stacked rows for the arena evaluator (`circuit/arena_eval.py`). NEVER use
outside tests: they require the secret.
"""

from __future__ import annotations

import torch

from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..ops.elementwise import ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import EVAL, Poly, residue_planes_from_ints
from ..sampler import Trapdoor
from .lwe import derive_a_lt_matrices_batch, derive_a_lt_matrix, derive_a_lt_stacked
from .public_lut import const_values, lut_input_values


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

    def public_lookup_rows(self, params, luts, gate_ids, lut_ids, in_pk, in_pt):
        """`public_lookup_batch` over stacked input rows [L, B, d, m, n]:
        (A_LT rows, None, None)."""
        return derive_a_lt_stacked(params, in_pk.shape[2], self.hash_key, gate_ids,
                                   device=in_pk.device), None, None

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

    def _lookup(self, params, luts, gate_ids, lut_ids, zs, d, slot_idxs=None):
        """B lookups of the inputs' constants zs: (A_LT [L, B, d, m, n],
        s (A_LT - y G) [L, B, 1, m, n], y residues [L, B]). Each (table, z)
        is looked up once per evaluator."""
        memo = self.__dict__.setdefault("_y_memo", {})
        ys = []
        for plt, gate_id, lut_id, z in zip(luts, gate_ids, lut_ids, zs):
            key = (id(plt), z)
            y = memo.get(key)
            if y is None:
                got = plt.get(params, z)
                if got is None:
                    raise KeyError(f"{z} not found in LUT {lut_id} for gate {gate_id}")
                y = memo[key] = (plt, int(got[1].value))  # the table kept: its id stays
            ys.append(y[1])
        device = self.secret_vec.data.device
        y_res = torch.from_numpy(residue_planes_from_ints(params, ys).astype("int64")).to(device)
        a_lt = derive_a_lt_stacked(params, d, self.hash_key, gate_ids, device=device,
                                   slot_idxs=slot_idxs)
        L, B, _, m, n = a_lt.shape
        vec = _lut_enc_vectors(
            a_lt.reshape(L, B * d, m, n), y_res, self.secret_vec.to_eval().data,
            PolyMatrix.gadget_matrix(params, d, device).data, params.tables(device).moduli,
        )  # [B, L, 1, m, n]
        return a_lt, vec.transpose(0, 1), y_res

    def public_lookup_rows(self, params, luts, gate_ids, lut_ids, in_pk, in_pt):
        """`public_lookup_batch` over stacked input rows (public keys
        [L, B, d, m, n], plaintexts [L, B, n]): (A_LT rows, s (A_LT - y G)
        rows [L, B, 1, m, n], y rows [L, B, n])."""
        zs = const_values(params, in_pt[:, :, 0])
        a_lt, vec, y_res = self._lookup(params, luts, gate_ids, lut_ids, zs, in_pk.shape[2])
        return a_lt, vec, y_res[:, :, None].expand(-1, -1, params.n)

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
        per item or None: `public_lookup_rows`' lookups, one output per
        item; equal to per-gate `public_lookup`. The outputs are views of the
        batch's result on the device."""
        zs = lut_input_values(params, [it[1].plaintext for it in items])
        a_lt, vec, y_res = self._lookup(
            params, [it[0] for it in items], [it[2] for it in items], [it[3] for it in items],
            zs, items[0][1].pubkey.matrix.nrow, slot_idxs)
        n = params.n
        return [
            BggEncoding(PolyMatrix(vec[:, i], EVAL, params),
                        BggPublicKey(PolyMatrix(a_lt[:, i], EVAL, params), True),
                        Poly(y_res[:, i : i + 1].expand(-1, n).contiguous(), EVAL, params))
            for i in range(len(items))
        ]
