"""Packed slot-wise BGG encoding: one shared pubkey, per-slot vectors.

The port's counterpart of `mxx_tpu/bgg/poly_encoding.py` (reference:
src/bgg/poly_encoding.rs and the `BGGPolyEncodingSampler` of
bgg/sampler.rs:190-529). The S slot vectors are the S rows of ONE device
matrix, so every slot-parallel wire op is a single batched op:

- slot s holds c_s = sigma_s A - x_s (sigma_s G) + e_s, sigma_s = mask_s * s
  with per-slot ternary masks;
- Add/Sub are one matrix add; Mul is one [S, m] @ G^{-1}(A_2) matmul plus one
  row-broadcast plaintext multiply (a torch broadcast of the [L, S, n]
  plaintext planes over the columns).

Everything lives on the device of the secrets (sampler) or of the wires.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..matrix import PolyMatrix
from ..ops.elementwise import ew_mul
from ..ring.poly import EVAL, Poly
from ..sampler import GaussDist, TernaryDist, UniformSampler
from .public_key import BggPublicKey


def _row_broadcast_mul(vectors: PolyMatrix, slot_polys: list[Poly]) -> PolyMatrix:
    """Multiply row s of `vectors` by slot_polys[s] (single batched op)."""
    params = vectors.params
    pts = torch.stack([p.to_eval().data for p in slot_polys], dim=1)  # [L, S, n]
    a = vectors.to_eval().data
    out = ew_mul(a, pts[:, :, None, :], params.tables(a.device).moduli)
    return PolyMatrix(out, EVAL, params)


@dataclass(frozen=True)
class BggPolyEncoding:
    vectors: PolyMatrix  # S x m (slot s = row s)
    pubkey: BggPublicKey  # shared d x m
    plaintexts: tuple[Poly, ...] | None

    @property
    def num_slots(self) -> int:
        return self.vectors.nrow

    def vector(self, slot: int) -> PolyMatrix:
        return self.vectors.slice_rows(slot, slot + 1)

    def plaintext(self, slot: int) -> Poly | None:
        return None if self.plaintexts is None else self.plaintexts[slot]

    def __add__(self, other: "BggPolyEncoding") -> "BggPolyEncoding":
        pts = (
            tuple(a + b for a, b in zip(self.plaintexts, other.plaintexts))
            if self.plaintexts is not None and other.plaintexts is not None
            else None
        )
        return BggPolyEncoding(self.vectors + other.vectors, self.pubkey + other.pubkey, pts)

    def __sub__(self, other: "BggPolyEncoding") -> "BggPolyEncoding":
        pts = (
            tuple(a - b for a, b in zip(self.plaintexts, other.plaintexts))
            if self.plaintexts is not None and other.plaintexts is not None
            else None
        )
        return BggPolyEncoding(self.vectors - other.vectors, self.pubkey - other.pubkey, pts)

    def __mul__(self, other: "BggPolyEncoding") -> "BggPolyEncoding":
        assert self.plaintexts is not None, "left operand must reveal plaintexts"
        decomposed = other.pubkey.matrix.decompose()
        first = self.vectors @ decomposed  # ALL slots in one matmul
        second = _row_broadcast_mul(other.vectors, list(self.plaintexts))
        pts = (
            tuple(a * b for a, b in zip(self.plaintexts, other.plaintexts))
            if other.plaintexts is not None
            else None
        )
        pk = BggPublicKey(
            self.pubkey.matrix @ decomposed,
            self.pubkey.reveal_plaintext and other.pubkey.reveal_plaintext,
        )
        return BggPolyEncoding(first + second, pk, pts)

    def small_scalar_mul(self, params, scalar: list[int]) -> "BggPolyEncoding":
        coeffs = list(scalar) + [0] * (params.n - len(scalar))
        p = Poly.from_int_coeffs(params, coeffs, self.vectors.data.device)
        pts = (
            tuple(x * p for x in self.plaintexts) if self.plaintexts is not None else None
        )
        return BggPolyEncoding(
            self.vectors.mul_poly_scalar(p),
            BggPublicKey(self.pubkey.matrix.mul_poly_scalar(p), self.pubkey.reveal_plaintext),
            pts,
        )

    def large_scalar_mul(self, params, scalar: list[int]) -> "BggPolyEncoding":
        device = self.vectors.data.device
        coeffs = list(scalar) + [0] * (params.n - len(scalar))
        p = Poly.from_int_coeffs(params, coeffs, device)
        gadget = PolyMatrix.gadget_matrix(params, self.pubkey.matrix.nrow, device)
        dec = gadget.mul_poly_scalar(p).decompose()
        pts = (
            tuple(x * p for x in self.plaintexts) if self.plaintexts is not None else None
        )
        return BggPolyEncoding(
            self.vectors @ dec,
            BggPublicKey(self.pubkey.matrix @ dec, self.pubkey.reveal_plaintext),
            pts,
        )

    def __eq__(self, other):
        if not isinstance(other, BggPolyEncoding):
            return NotImplemented
        return self.vectors == other.vectors and self.pubkey == other.pubkey

    def __hash__(self):
        return id(self)


class BGGPolyEncodingSampler:
    """Per-slot masked secrets over one shared pubkey set
    (reference sampler.rs:190-529), on the device of the secrets."""

    def __init__(self, params, secrets: list[Poly], num_slots: int,
                 gauss_sigma: float | None = None, seed: int | None = None):
        self.params = params
        self.d = len(secrets)
        self.num_slots = num_slots
        self.gauss_sigma = gauss_sigma
        self.device = secrets[0].data.device
        us = UniformSampler(seed, self.device)
        self._uniform = us
        self.masks = [us.sample_poly(params, TernaryDist()) for _ in range(num_slots)]
        # secret_rows[s] = mask_s * secrets  (S x d)
        self.secret_mat = PolyMatrix.from_polys(
            params, [[m * sj for sj in secrets] for m in self.masks]
        )

    def sample(self, params, public_keys: list[BggPublicKey],
               slot_plaintexts: list[list[Poly]]) -> list[BggPolyEncoding]:
        """public_keys: [one] + per-input (shared across slots);
        slot_plaintexts: per input, one plaintext per slot."""
        assert len(public_keys) == 1 + len(slot_plaintexts)
        S = self.num_slots
        d = self.d
        g = PolyMatrix.gadget_matrix(params, d, self.device)
        sg = self.secret_mat @ g  # S x m
        out = []
        all_pts = [[Poly.one(params, self.device)] * S] + list(slot_plaintexts)
        for pk, pts in zip(public_keys, all_pts):
            assert len(pts) == S
            first = self.secret_mat @ pk.matrix  # S x m
            second = _row_broadcast_mul(sg, pts)
            vectors = first - second
            if self.gauss_sigma:
                vectors = vectors + self._uniform.sample_uniform(
                    params, S, vectors.ncol, GaussDist(self.gauss_sigma)
                )
            out.append(
                BggPolyEncoding(
                    vectors, pk, tuple(pts) if pk.reveal_plaintext else None
                )
            )
        return out


class LWEBGGPolyPubKeyPltEvaluator:
    """Offline LWE evaluator for packed encodings: one shared A_LT per gate
    (slot None), per-slot K_low/K_high artifacts (reference
    lookup/lwe/pubkey.rs packed path + poly_encoding.rs). Targets and
    preimages live on the device of `pub_matrix`."""

    def __init__(self, hash_key, trap_sampler, pub_matrix, trapdoor, dir_path, num_slots):
        from ..lookup.lwe import LWEBGGPubKeyPltEvaluator

        self.scalar = LWEBGGPubKeyPltEvaluator(
            hash_key, trap_sampler, pub_matrix, trapdoor, dir_path
        )
        self.num_slots = num_slots

    def public_lookup(self, params, plt, one, input_pk: BggPublicKey, gate_id, lut_id):
        # shared A_LT (slot None); record one gate state
        return self.scalar.public_lookup(params, plt, one, input_pk, gate_id, lut_id)

    def sample_aux_matrices(self, params):
        """Per-slot K_high artifacts against the shared A_LT."""
        from ..lookup.lwe import derive_k_low, k_high_checkpoint_prefix
        from ..storage import add_lookup_buffer, get_lookup_buffer

        scalar = self.scalar
        device = scalar.pub_matrix.data.device
        for (ctx, gate_id, _slot0), state in list(scalar.gate_state.items()):
            plt = state.plt
            row_size = scalar.pub_matrix.nrow
            gadget = PolyMatrix.gadget_matrix(params, row_size, device)
            for s in range(self.num_slots):
                rows = []
                for x_k, (k, y_k) in plt.entries(params):
                    x_poly = Poly.const(params, x_k, device)
                    y_poly = Poly.from_elem_to_constant(params, y_k, device)
                    ext = state.input_pubkey - gadget.mul_poly_scalar(x_poly)
                    target = state.output_pubkey - gadget.mul_poly_scalar(y_poly)
                    k_low = derive_k_low(
                        params, row_size, scalar.hash_key, gate_id, state.lut_id,
                        k, s, ctx, device=device,
                    )
                    adjusted = target - ext @ k_low
                    k_high = scalar.trap_sampler.preimage(
                        params, scalar.trapdoor, scalar.pub_matrix, adjusted
                    )
                    rows.append((k, k_high))
                add_lookup_buffer(
                    get_lookup_buffer(
                        rows, k_high_checkpoint_prefix(gate_id, state.lut_id, s, ctx)
                    )
                )
        scalar.gate_state.clear()


class LWEBGGPolyEncodingPltEvaluator:
    """Online LWE lookup over packed encodings: per-slot c_b rows + per-slot
    artifacts, shared output pubkey; the slot loop restacks into one matrix
    (reference lookup/lwe/poly_encoding.rs:32-120). K_high is read onto the
    device of `c_b_rows`."""

    def __init__(self, hash_key: bytes, dir_path, c_b_rows: PolyMatrix):
        self.hash_key = hash_key
        self.dir_path = dir_path
        self.c_b_rows = c_b_rows  # S x m_b, row s = sigma_s * B (+ e)
        self.context: str = ""  # per-circuit namespace (set_plt_context)

    def public_lookup(self, params, plt, one, input_enc: BggPolyEncoding, gate_id, lut_id):
        from ..lookup.lwe import derive_a_lt_matrix, derive_k_low, k_high_checkpoint_prefix
        from ..storage import read_matrix_from_multi_batch

        assert input_enc.plaintexts is not None
        device = self.c_b_rows.data.device
        row_size = input_enc.pubkey.matrix.nrow
        ctx = self.context
        a_lt = derive_a_lt_matrix(params, row_size, self.hash_key, gate_id, None, ctx,
                                  device=device)
        rows = []
        out_pts = []
        for s in range(input_enc.num_slots):
            z = input_enc.plaintext(s).const_coeff()
            k, y_k = plt.get_checked(params, int(z))
            out_pts.append(Poly.from_elem_to_constant(params, y_k, device))
            k_high = read_matrix_from_multi_batch(
                params, self.dir_path,
                k_high_checkpoint_prefix(gate_id, lut_id, s, ctx), k, device,
            )
            assert k_high is not None, f"missing K_high for gate {gate_id} slot {s} row {k}"
            k_low = derive_k_low(
                params, row_size, self.hash_key, gate_id, lut_id, k, s, ctx, device=device
            )
            c_b = self.c_b_rows.slice_rows(s, s + 1)
            rows.append(c_b @ k_high + input_enc.vector(s) @ k_low)
        vectors = rows[0].concat_rows(rows[1:])
        return BggPolyEncoding(vectors, BggPublicKey(a_lt, True), tuple(out_pts))
