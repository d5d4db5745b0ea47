"""Preimage-backed slot transfer for packed (BggPolyEncoding) wires.

The port's counterpart of `mxx_tpu/slot_transfer/preimage.py` (reference:
src/slot_transfer/{bgg_pubkey.rs,bgg_poly_encoding.rs}). Packed wires carry one row per slot under per-slot
secrets sigma_s = t S_s (t the base secret row, S_s a ternary d x d slot
mat). Slot transfer re-encodes the value of a source slot under the
destination slot's secret and a fresh hash-derived output pubkey, entirely
through stored trapdoor preimages:

- aux per slot s (bgg_pubkey.rs:212-258):
    P1_s = B1^{-1}([A_s ; -S_s G] + E)        (B1 a 2d-row trapdoor)
    P0_s = B0^{-1}([S_s | I] B1 + E)          (B0 a d-row trapdoor)
  so online, with c_b0 ~ t B0:
    c_b0 P0_src P1_dst ~ sigma_src A_dst - sigma_dst G   (the transfer key)
- per transfer gate and destination slot (bgg_pubkey.rs:261-293):
    P_gate = B0^{-1}(S_dst A_out - (S_src A_in) G^{-1}(A_dst) scalar + E)
- online (bgg_poly_encoding.rs:119-248):
    pre  = c_src G^{-1}(A_dst) + x (c_b0 P0_src P1_dst)
         = sigma_src A_in G^{-1}(A_dst) - x sigma_dst G
    out  = c_b0 P_gate + scalar * pre = sigma_dst A_out - scalar x sigma_dst G
- slot_reduce packs each input's leading slots into one polynomial via
  monomial scalars X^src (bgg_pubkey.rs:296-339, bgg_poly_encoding.rs:250+).

The offline evaluator samples on its `device`; the online evaluator reads
the artifacts onto the device of `c_b0`.
"""

from __future__ import annotations

import hashlib

from ..bgg import BggPublicKey
from ..bgg.poly_encoding import BggPolyEncoding
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import (
    FinRingDist,
    GaussDist,
    HashSampler,
    TernaryDist,
    TrapdoorSampler,
    UniformSampler,
)

ST_AUX_PREFIX = "st_aux"


def _slot_a(params, hash_key: bytes, d: int, slot_idx: int, device) -> PolyMatrix:
    return HashSampler(device).sample_hash(
        params, hash_key, f"slot_transfer_slot_a_{slot_idx}", d,
        d * params.modulus_digits, FinRingDist(),
    )


def _gate_a_out(params, hash_key: bytes, d: int, gate_id: int, reduce: bool,
                device) -> PolyMatrix:
    tag = "slot_reduce_gate_a_out_" if reduce else "slot_transfer_gate_a_out_"
    return HashSampler(device).sample_hash(
        params, hash_key, f"{tag}{gate_id}", d, d * params.modulus_digits, FinRingDist(),
    )


def _monomial(params, s: int, device) -> Poly:
    coeffs = [0] * params.n
    coeffs[s] = 1
    return Poly.from_int_coeffs(params, coeffs, device)


class BggPublicKeySTEvaluator:
    """Offline pass: record slot gates during pubkey evaluation, then sample
    and store the slot/gate preimage artifacts (bgg_pubkey.rs:140-1057)."""

    def __init__(self, hash_key: bytes, num_slots: int, trapdoor_sigma: float,
                 error_sigma: float, dir_path, secret_size: int = 1,
                 seed: int | None = None, device="cuda"):
        self.hash_key = hash_key
        self.num_slots = num_slots
        self.trapdoor_sigma = trapdoor_sigma
        self.error_sigma = error_sigma
        self.dir_path = dir_path
        self.d = secret_size
        self.seed = seed
        self.device = device
        # gate_id -> ("transfer", input_pk, src_slots) | ("reduce", [pks], num_slots)
        self.gate_states: dict[int, tuple] = {}
        self.slot_secret_mats: list[PolyMatrix] | None = None

    # ------------------------------------------------------------- naming

    def checkpoint_prefix(self, params) -> str:
        kd = hashlib.sha256(self.hash_key).hexdigest()[:16]
        return (
            f"{ST_AUX_PREFIX}_n{params.n}_L{params.crt_depth}_b{params.base_bits}"
            f"_d{self.d}_ns{self.num_slots}_ts{self.trapdoor_sigma}"
            f"_es{self.error_sigma}_key{kd}"
        )

    def _b0_id(self, params) -> str:
        return f"{self.checkpoint_prefix(params)}_b0"

    def _slot_p0_id(self, params, s: int) -> str:
        return f"{self.checkpoint_prefix(params)}_slot_preimage_b0_{s}"

    def _slot_p1_id(self, params, s: int) -> str:
        return f"{self.checkpoint_prefix(params)}_slot_preimage_b1_{s}"

    def _gate_id(self, params, gate_id: int, dst: int) -> str:
        return f"{self.checkpoint_prefix(params)}_gate_preimage_{gate_id}_dst{dst}"

    # ------------------------------------------------- circuit-eval surface

    def slot_transfer(self, params, input_pk: BggPublicKey, src_slots, gate_id):
        assert len(src_slots) <= params.n
        self.gate_states[gate_id] = ("transfer", input_pk, list(src_slots))
        return BggPublicKey(
            _gate_a_out(params, self.hash_key, self.d, gate_id, False, self.device), True
        )

    def slot_reduce(self, params, inputs: list[BggPublicKey], num_slots: int, gate_id):
        assert 0 < num_slots <= params.n
        self.gate_states[gate_id] = ("reduce", list(inputs), num_slots)
        return BggPublicKey(
            _gate_a_out(params, self.hash_key, self.d, gate_id, True, self.device), True
        )

    # ---------------------------------------------------------- aux pass

    def _error(self, us: UniformSampler, params, nrow: int, ncol: int) -> PolyMatrix | None:
        if self.error_sigma == 0.0:
            return None
        return us.sample_uniform(params, nrow, ncol, GaussDist(self.error_sigma))

    def sample_aux_matrices(self, params, slot_secret_mats: list[PolyMatrix] | None = None):
        """Sample B0/B1, the per-slot aux preimages, and every recorded gate
        preimage; persist them under `checkpoint_prefix` (bgg_pubkey.rs:824+).

        `slot_secret_mats` lets the caller supply the S_s mats matching an
        existing packed-encoding sampler (sigma_s = t S_s); by default fresh
        ternary mats are sampled and exposed via `self.slot_secret_mats`."""
        from ..storage import add_lookup_buffer, get_lookup_buffer

        d = self.d
        dev = self.device
        ts = TrapdoorSampler(params, self.trapdoor_sigma, seed=self.seed, device=dev)
        us = UniformSampler(self.seed, dev)
        td0, b0 = ts.trapdoor(params, d)
        td1, b1 = ts.trapdoor(params, 2 * d)
        self.b0_matrix = b0
        self.b1_matrix = b1
        if slot_secret_mats is None:
            slot_secret_mats = [
                us.sample_uniform(params, d, d, TernaryDist())
                for _ in range(self.num_slots)
            ]
        assert len(slot_secret_mats) == self.num_slots
        self.slot_secret_mats = slot_secret_mats
        add_lookup_buffer(get_lookup_buffer([(0, b0)], self._b0_id(params)))

        gadget = PolyMatrix.gadget_matrix(params, d, dev)
        identity = PolyMatrix.identity(params, d, device=dev)
        for s, s_mat in enumerate(slot_secret_mats):
            a_s = _slot_a(params, self.hash_key, d, s, dev)
            t1 = a_s.concat_rows([-(s_mat @ gadget)])
            e1 = self._error(us, params, 2 * d, t1.ncol)
            p1 = ts.preimage(params, td1, b1, t1 if e1 is None else t1 + e1)
            t0 = s_mat.concat_columns([identity]) @ b1
            e0 = self._error(us, params, d, t0.ncol)
            p0 = ts.preimage(params, td0, b0, t0 if e0 is None else t0 + e0)
            add_lookup_buffer(get_lookup_buffer([(0, p1)], self._slot_p1_id(params, s)))
            add_lookup_buffer(get_lookup_buffer([(0, p0)], self._slot_p0_id(params, s)))

        for gate_id, state in self.gate_states.items():
            if state[0] == "transfer":
                _, input_pk, src_slots = state
                a_out = _gate_a_out(params, self.hash_key, d, gate_id, False, dev)
                for dst, (src, scalar) in enumerate(src_slots):
                    a_dst = _slot_a(params, self.hash_key, d, dst, dev)
                    rhs = (slot_secret_mats[src] @ input_pk.matrix) @ a_dst.decompose()
                    if scalar is not None:
                        rhs = rhs.mul_poly_scalar(Poly.const(params, scalar, dev))
                    target = slot_secret_mats[dst] @ a_out - rhs
                    e = self._error(us, params, d, target.ncol)
                    p = ts.preimage(params, td0, b0, target if e is None else target + e)
                    add_lookup_buffer(
                        get_lookup_buffer([(0, p)], self._gate_id(params, gate_id, dst))
                    )
            else:
                _, input_pks, num_slots = state
                a_out = _gate_a_out(params, self.hash_key, d, gate_id, True, dev)
                for dst, pk in enumerate(input_pks):
                    a_dst = _slot_a(params, self.hash_key, d, dst, dev)
                    a_dst_dec = a_dst.decompose()
                    acc = None
                    for src in range(num_slots):
                        term = (
                            (slot_secret_mats[src] @ pk.matrix) @ a_dst_dec
                        ).mul_poly_scalar(_monomial(params, src, dev))
                        acc = term if acc is None else acc + term
                    target = slot_secret_mats[dst] @ a_out - acc
                    e = self._error(us, params, d, target.ncol)
                    p = ts.preimage(params, td0, b0, target if e is None else target + e)
                    add_lookup_buffer(
                        get_lookup_buffer([(0, p)], self._gate_id(params, gate_id, dst))
                    )

    def load_b0_matrix_checkpoint(self, params) -> PolyMatrix:
        from ..storage import read_matrix_from_multi_batch

        m = read_matrix_from_multi_batch(params, self.dir_path, self._b0_id(params), 0,
                                         self.device)
        assert m is not None, "slot-transfer b0 checkpoint not found"
        return m


class BggPolyEncodingSTEvaluator:
    """Online pass: evaluate slot gates over packed encodings through the
    stored preimages, with c_b0 ~ t B0 (bgg_poly_encoding.rs:26-563)."""

    def __init__(self, hash_key: bytes, dir_path, checkpoint_prefix: str,
                 params, c_b0: PolyMatrix):
        self.hash_key = hash_key
        self.dir_path = dir_path
        self.prefix = checkpoint_prefix
        self.params = params
        self.c_b0 = c_b0
        self.d = c_b0.nrow
        self.device = c_b0.data.device

    def _read(self, id_suffix: str) -> PolyMatrix:
        from ..storage import read_matrix_from_multi_batch

        m = read_matrix_from_multi_batch(
            self.params, self.dir_path, f"{self.prefix}_{id_suffix}", 0, self.device
        )
        assert m is not None, f"missing slot-transfer artifact {self.prefix}_{id_suffix}"
        return m

    def _c_transfer(self, src: int, dst: int) -> PolyMatrix:
        p0 = self._read(f"slot_preimage_b0_{src}")
        p1 = self._read(f"slot_preimage_b1_{dst}")
        return (self.c_b0 @ p0) @ p1

    def slot_transfer(self, params, input_enc: BggPolyEncoding, src_slots, gate_id):
        assert input_enc.plaintexts is not None, "slot transfer needs revealed plaintexts"
        d = self.d
        dev = self.device
        a_out = _gate_a_out(params, self.hash_key, d, gate_id, False, dev)
        rows, pts = [], []
        for dst, (src, scalar) in enumerate(src_slots):
            assert src < input_enc.num_slots, f"source slot {src} out of range"
            a_dst = _slot_a(params, self.hash_key, d, dst, dev)
            x = Poly.const(params, input_enc.plaintext(src).const_value(), dev)
            pre = input_enc.vector(src) @ a_dst.decompose() + self._c_transfer(
                src, dst
            ).mul_poly_scalar(x)
            out_pt = x
            if scalar is not None:
                sp = Poly.const(params, scalar, dev)
                pre = pre.mul_poly_scalar(sp)
                out_pt = out_pt * sp
            c_gate = self.c_b0 @ self._read(f"gate_preimage_{gate_id}_dst{dst}")
            rows.append(c_gate + pre)
            pts.append(out_pt)
        return BggPolyEncoding(
            rows[0].concat_rows(rows[1:]), BggPublicKey(a_out, True), tuple(pts)
        )

    def slot_reduce(self, params, inputs: list[BggPolyEncoding], num_slots: int, gate_id):
        d = self.d
        dev = self.device
        a_out = _gate_a_out(params, self.hash_key, d, gate_id, True, dev)
        rows, pts = [], []
        for dst, enc in enumerate(inputs):
            assert enc.num_slots >= num_slots
            assert enc.plaintexts is not None
            a_dst_dec = _slot_a(params, self.hash_key, d, dst, dev).decompose()
            acc = None
            out_pt = Poly.zero(params, device=dev)
            for src in range(num_slots):
                x = Poly.const(params, enc.plaintext(src).const_value(), dev)
                mono = _monomial(params, src, dev)
                pre_slot = (
                    enc.vector(src) @ a_dst_dec
                    + self._c_transfer(src, dst).mul_poly_scalar(x)
                ).mul_poly_scalar(mono)
                acc = pre_slot if acc is None else acc + pre_slot
                out_pt = out_pt + x * mono
            c_gate = self.c_b0 @ self._read(f"gate_preimage_{gate_id}_dst{dst}")
            rows.append(c_gate + acc)
            pts.append(out_pt)
        return BggPolyEncoding(
            rows[0].concat_rows(rows[1:]), BggPublicKey(a_out, True), tuple(pts)
        )
