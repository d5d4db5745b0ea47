"""WEE25-commitment-backed LUT evaluation (offline commit / online open).

The port's counterpart of `mxx_tpu/lookup/commit_eval.py`. Instead of
storing a per-row key matrix for every LUT entry (the LWE/GGH15 evaluators),
the whole table is folded into ONE short WEE25 commitment:

- For gate g (input pubkey A_in, one pubkey A_one) and LUT row j with entry
  (idx_j, y_j), the committed message block at global position start_g + j is
      M = pad(A_out_g - G y_j) + R_{g,idx_j} - (A_in + A_one) G^{-1}(C_j)
  where R is hash-derived and the canceler is
      C_j = (B_1 V_{start_g+idx_j} + R_{g,idx_j}) * (idx_j + 1)^{-1}.
  V_i is the WEE25 verifier column for position i, satisfying
  commit * V_i = M_i - B * Z_i for the opening Z_i.
- Offline: commit all blocks, then store the B0-preimage of (commit + B_1).
- Online, for plaintext x with (k, y) = lut(x) (requires k == x; constant
  plaintexts only): with c_b0 = s B0 and c_b = s B,
      c_commit = c_b0 * preimage           ~ s (commit + B_1)
      c_lut    = c_commit V_k + c_b Z_k    ~ s M_k + s B_1 V_k
      c_x      = (c_in + c_one) G^{-1}(C_k)
  and since c_in + c_one = s (A_in + A_one) - (x+1) s G, the R/B_1 V/canceler
  terms telescope exactly, leaving the first m_g columns equal to
  s (A_out - G y): a fresh BGG encoding of the looked-up value under the
  hash-derived output key.

Device form: the message blocks draw every R_{g,i} of the table in one hash
batch and each gate's A_out once. Everything lives on the device of the
public params' B.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bgg import BggEncoding, BggPublicKey
from ..commit import MsgMatrixStream, Wee25Commit, Wee25PublicParams
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import FinRingDist, HashSampler
from ..storage import add_lookup_buffer, get_lookup_buffer, read_matrix_from_multi_batch
from ..utils.numth import modinv
from .public_lut import PublicLut

PREIMAGE_OF_COMMIT_ID = "preimage_of_commit"


def _a_out_tag(gate_id: int) -> str:
    return f"COMMIT_A_OUT_{gate_id}"


def _r_tag(gate_id: int, index: int) -> str:
    return f"COMMIT_R_{gate_id}_{index}"


def derive_a_out_matrix(params, row_size: int, hash_key: bytes, gate_id: int,
                        device="cuda") -> PolyMatrix:
    """Hash-derived output pubkey A_out (commit_eval.rs:587-601)."""
    return HashSampler(device).sample_hash(
        params, hash_key, _a_out_tag(gate_id), row_size,
        row_size * params.modulus_digits, FinRingDist(),
    )


def derive_r_g_i_matrix(params, row_size: int, m_b: int, hash_key: bytes,
                        gate_id: int, index: int, device="cuda") -> PolyMatrix:
    """Hash-derived blinding matrix R_{g,i} (commit_eval.rs:603-625)."""
    return HashSampler(device).sample_hash(
        params, hash_key, _r_tag(gate_id, index), row_size, m_b, FinRingDist(),
    )


def derive_canceler_matrix(params, b_1: PolyMatrix, verifier_slice: PolyMatrix,
                           r_g_i: PolyMatrix, idx: int) -> PolyMatrix:
    """(B_1 V_i + R_{g,i}) * (i+1)^{-1} (commit_eval.rs:627-637)."""
    inv = modinv((idx + 1) % params.modulus, params.modulus)
    return (b_1 @ verifier_slice + r_g_i).mul_int_scalar(inv)


@dataclass
class _GateState:
    gate_id: int
    lut_id: int
    one_pubkey: BggPublicKey
    input_pubkey: BggPublicKey


class GateStateCollector:
    """Pass-1 PltEvaluator: records gate states, returns hash-derived A_out
    (commit_eval.rs:22-77)."""

    def __init__(self, hash_key: bytes):
        self.hash_key = hash_key
        self.gate_states: dict[int, _GateState] = {}
        self.luts: dict[int, PublicLut] = {}

    def public_lookup(self, params, plt, one, input_pk, gate_id, lut_id):
        self.luts.setdefault(lut_id, plt)
        self.gate_states[gate_id] = _GateState(gate_id, lut_id, one, input_pk)
        m = input_pk.matrix
        return BggPublicKey(
            derive_a_out_matrix(params, m.nrow, self.hash_key, gate_id, m.data.device), True
        )


@dataclass
class _LutLayout:
    """Global message-vector layout: one contiguous range of rows per LUT
    gate, sorted by gate id (commit_eval.rs:524-574)."""

    start_ids: dict[int, int]           # gate_id -> global start index
    lut_vector_len: int
    padded_len: int                     # next power of tree_base
    gate_ranges: list[tuple[int, int, _GateState]]  # (start, end, state)


def _build_layout(luts: dict[int, PublicLut], gate_states: dict[int, _GateState],
                  tree_base: int) -> _LutLayout:
    start_ids: dict[int, int] = {}
    ranges = []
    cursor = 0
    for gid in sorted(gate_states):
        state = gate_states[gid]
        start_ids[gid] = cursor
        end = cursor + len(luts[state.lut_id])
        ranges.append((cursor, end, state))
        cursor = end
    padded = tree_base
    while padded < cursor:
        padded *= tree_base
    return _LutLayout(start_ids, cursor, padded, ranges)


def _build_msg_blocks(params, scheme: Wee25Commit, pp: Wee25PublicParams,
                      b_1: PolyMatrix, hash_key: bytes, luts, gate_states,
                      ) -> tuple[list[PolyMatrix], _LutLayout]:
    """Materialize the committed message vector (commit_eval.rs:417-522),
    once, shared by the offline commit and every online opening."""
    if not gate_states:
        raise ValueError("no LUT gates found for the commit evaluator")
    layout = _build_layout(luts, gate_states, scheme.tree_base)
    d, m_b, m_g = scheme.d, scheme.m_b, scheme.m_g
    device = pp.b.data.device
    gadget = PolyMatrix.gadget_matrix(params, d, device)
    hs = HashSampler(device)
    rows = []  # (position, gate state, idx, y) of every table row
    for start, end, state in layout.gate_ranges:
        for gidx in range(start, end):
            idx, y = luts[state.lut_id].get_checked(params, gidx - start)
            rows.append((start, state, idx, y))
    r_all = hs.sample_hash_batch(params, hash_key, [_r_tag(st.gate_id, idx)
                                                    for _, st, idx, _ in rows],
                                 d, m_b, FinRingDist())
    gate_ids = [st.gate_id for _, _, st in layout.gate_ranges]
    a_outs = dict(zip(gate_ids, hs.sample_hash_batch(
        params, hash_key, [_a_out_tag(g) for g in gate_ids], d, m_g, FinRingDist())))
    pad = PolyMatrix.zero(params, d, m_b - m_g, device=device)
    blocks: list[PolyMatrix] = []
    for (start, state, idx, y), r_g_i in zip(rows, r_all):
        y_poly = Poly.from_elem_to_constant(params, y, device)
        v_slice = scheme.verifier(
            params, layout.padded_len, range(start + idx, start + idx + 1), pp
        )
        canceler = derive_canceler_matrix(params, b_1, v_slice, r_g_i, idx)
        padded = (a_outs[state.gate_id] - gadget.mul_poly_scalar(y_poly)).concat_columns([pad])
        pubkey_sum = state.input_pubkey.matrix + state.one_pubkey.matrix
        blocks.append(padded + r_g_i - pubkey_sum @ canceler.decompose())
    blocks.extend(PolyMatrix.zero(params, d, m_b, device=device)
                  for _ in range(layout.lut_vector_len, layout.padded_len))
    return blocks, layout


def _derive_b1(params, scheme: Wee25Commit, hash_key: bytes, device) -> PolyMatrix:
    return HashSampler(device).sample_hash(
        params, hash_key, "COMMIT_LUT_B1", scheme.d, scheme.m_b, FinRingDist()
    )


class CommitBGGPubKeyPltEvaluator:
    """Offline pass: collect LUT gate states during pubkey evaluation, then
    commit the full message vector and store the B0-preimage of
    (commit + B_1) (commit_eval.rs:77-208)."""

    def __init__(self, params, scheme: Wee25Commit, pp: Wee25PublicParams, hash_key: bytes):
        self.params = params
        self.scheme = scheme
        self.pp = pp
        self.hash_key = hash_key
        self.b_1 = _derive_b1(params, scheme, hash_key, pp.b.data.device)
        self.collector = GateStateCollector(hash_key)

    def public_lookup(self, params, plt, one, input_pk, gate_id, lut_id):
        return self.collector.public_lookup(params, plt, one, input_pk, gate_id, lut_id)

    def commit_all_lut_matrices(self, trap_sampler, b0_trapdoor, b0_matrix: PolyMatrix):
        """Commit every registered table and persist the commitment preimage
        (commit_eval.rs:136-179)."""
        params = self.params
        blocks, _layout = _build_msg_blocks(
            params, self.scheme, self.pp, self.b_1, self.hash_key,
            self.collector.luts, self.collector.gate_states,
        )
        commitment, _cache = self.scheme.commit(
            params, MsgMatrixStream.from_blocks(blocks), self.pp
        )
        target = commitment + self.b_1
        preimage = trap_sampler.preimage(params, b0_trapdoor, b0_matrix, target)
        add_lookup_buffer(get_lookup_buffer([(0, preimage)], PREIMAGE_OF_COMMIT_ID))


class CommitBGGEncodingPltEvaluator:
    """Online pass: re-derive the committed message vector from the circuit's
    pubkeys, recover c_commit ~ s (commit + B_1) through the stored preimage,
    and answer each lookup with a verifier/opening pair plus the canceler
    (commit_eval.rs:211-408). The commit cache is recomputed here, not
    loaded: the commitment is deterministic given pp and the message blocks."""

    def __init__(self, params, scheme: Wee25Commit, pp: Wee25PublicParams,
                 hash_key: bytes, circuit, one_pubkey: BggPublicKey,
                 input_pubkeys: list[BggPublicKey], c_b0: PolyMatrix,
                 c_b: PolyMatrix, dir_path):
        self.params = params
        self.scheme = scheme
        self.pp = pp
        self.hash_key = hash_key
        device = pp.b.data.device
        self.b_1 = _derive_b1(params, scheme, hash_key, device)
        self.c_b = c_b
        collector = GateStateCollector(hash_key)
        circuit.eval(params, one_pubkey, input_pubkeys, plt_evaluator=collector)
        self.luts = dict(collector.luts)
        self.gate_states = dict(collector.gate_states)
        self.blocks, self.layout = _build_msg_blocks(
            params, scheme, pp, self.b_1, hash_key, self.luts, self.gate_states
        )
        self.stream = MsgMatrixStream.from_blocks(self.blocks)
        _commitment, self.cache = scheme.commit(params, self.stream, pp)
        preimage = read_matrix_from_multi_batch(params, dir_path, PREIMAGE_OF_COMMIT_ID, 0,
                                                device)
        if preimage is None:
            raise KeyError(f"{PREIMAGE_OF_COMMIT_ID} not found in {dir_path}")
        self.c_commit = c_b0 @ preimage

    def public_lookup(self, params, plt, one, input_enc, gate_id, lut_id):
        if input_enc.plaintext is None:
            raise ValueError("BGG encoding must reveal its plaintext for a public lookup")
        x = input_enc.plaintext.const_value()
        got = plt.get(params, x)
        if got is None:
            raise KeyError(f"{x} not found in LUT for gate {gate_id}")
        k, y = got
        device = self.c_commit.data.device
        y_poly = Poly.from_elem_to_constant(params, y, device)
        pos = self.layout.start_ids[gate_id] + k
        scheme, pp = self.scheme, self.pp
        d = input_enc.pubkey.matrix.nrow
        opening = scheme.open(params, self.stream, range(pos, pos + 1), pp, self.cache)
        v_slice = scheme.verifier(params, self.layout.padded_len, range(pos, pos + 1), pp)
        r_g_i = derive_r_g_i_matrix(params, d, scheme.m_b, self.hash_key, gate_id, k, device)
        canceler = derive_canceler_matrix(params, self.b_1, v_slice, r_g_i, k)
        c_lut = self.c_commit @ v_slice + self.c_b @ opening
        c_x = (input_enc.vector + one.vector) @ canceler.decompose()
        c_out = (c_lut + c_x).slice_columns(0, scheme.m_g)
        a_out = derive_a_out_matrix(params, d, self.hash_key, gate_id, device)
        return BggEncoding(c_out, BggPublicKey(a_out, True), y_poly)
