"""GGH15-chain public lookup-table evaluators over BGG+ wires.

The port's counterpart of `mxx_tpu/lookup/ggh15.py`.

Structure: two trapdoors (B0, T0), (B1, T1). Per LUT entry x -> (row k, y), a
B1-preimage keyed by the INPUT value x

    L_x = B1^{-1}( W_id + W_gy G^{-1}(G y) + W_v V_k + W_vx (V_k x) ),

with hash-derived blocks W_id, W_gy, W_v, W_vx (d x m_g) per LUT and
V_k = HashDecomposed("ggh15_lut_v_idx_{lut}_{k}") per output row. Keying the
aux preimage by x (while V stays keyed by k) makes ARBITRARY x -> (k, y)
tables exact: the W_vx legs telescope because both sides use the same x.
The JAX package made this choice; the reference keys its aux by k, which
closes only for tables with x == k. Per gate g with input pubkey A_z, a
fresh ternary secret s_g and five B0-preimages:

    P1     = B0^{-1}( s_g B1 + e )
    P2_id  = B0^{-1}( s_g W_id + A_out + e )        A_out = Hash("ggh15_gate_a_out_{g}")
    P2_gy  = B0^{-1}( s_g W_gy - G + e )
    P2_v   = B0^{-1}( s_g W_v - A_z G^{-1}(U_g) + e )  U_g = Hash("ggh15_lut_u_g_matrix_{g}")
    P2_vx  = B0^{-1}( s_g W_vx + U_g + e )

Online, with c_b0 ~ s B0 and input wire (c_z, A_z, x):

    c_out = c_b0 [ P2_id + P2_gy G^{-1}(G y) + P2_v V_k + P2_vx (V_k x) - P1 L_x ]
            + c_z G^{-1}(U_g) V_k
          ~ s A_out - y (s G),

an encoding of y under A_out.

All artifacts persist under a deterministic checkpoint prefix, column-chunked,
and `sample_aux_matrices` resumes partially-sampled chains. The online
reduction walks the stored column chunks; the port multiplies from the left,
c_b0 (P R) as (c_b0 P) R, which is exact mod q and so equal to the JAX
package's c_out bit for bit. A chunk is read from its file while the device
works on the products queued for the chunk before it.

Device form: the offline pass draws each LUT's four W blocks in one hash
batch and the distinct V_k in batches, the online lookup its three hash
matrices in one. The offline evaluator works on its `device`; the online
one on the device of c_b0. Given a mesh, the offline preimage batches
shard their columns over its `col` axis.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import torch

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from ..bgg.poly_encoding import BggPolyEncoding
from ..matrix import PolyMatrix
from ..matrix.rows import decompose as decompose_rows
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import COEFF, EVAL, Poly
from ..sampler import (
    FinRingDist,
    GaussDist,
    HashSampler,
    TernaryDist,
    Trapdoor,
    TrapdoorSampler,
    UniformSampler,
)
from ..storage import (
    add_lookup_buffer,
    get_lookup_buffer,
    get_lookup_buffer_bytes,
    get_storage_system,
    read_bytes_from_multi_batch,
    read_matrix_from_multi_batch,
)
from ..utils.tracing import span
from .public_lut import PublicLut

W_TAGS = ("block_identity", "block_gy", "block_v", "block_vx")


# ------------------------------------------------------------ column chunking


def column_chunk_width(total_cols: int) -> int:
    if total_cols <= 0:
        raise ValueError(f"a stored matrix has columns, got {total_cols}")
    return min(total_cols, max(config.aux_sampling_chunk_width(), 1))


def column_chunk_count(total_cols: int) -> int:
    return -(-total_cols // column_chunk_width(total_cols))


def column_chunk_bounds(total_cols: int, chunk_idx: int) -> tuple[int, int]:
    w = column_chunk_width(total_cols)
    start = chunk_idx * w
    if start >= total_cols:
        raise ValueError(f"chunk {chunk_idx} starts past {total_cols} columns")
    return start, min(total_cols - start, w)


def chunk_prefix(id_prefix: str, chunk_idx: int) -> str:
    return f"{id_prefix}_chunk{chunk_idx}"


def store_matrix_chunked(matrix: PolyMatrix, id_prefix: str):
    total = matrix.ncol
    for ci in range(column_chunk_count(total)):
        s, ln = column_chunk_bounds(total, ci)
        add_lookup_buffer(
            get_lookup_buffer([(0, matrix.slice_columns(s, s + ln))], chunk_prefix(id_prefix, ci))
        )


def read_matrix_chunked(params, dir_path, id_prefix: str, total_cols: int,
                        device="cuda") -> PolyMatrix | None:
    chunks = []
    for ci in range(column_chunk_count(total_cols)):
        m = read_matrix_from_multi_batch(params, dir_path, chunk_prefix(id_prefix, ci), 0, device)
        if m is None:
            return None
        chunks.append(m)
    return chunks[0] if len(chunks) == 1 else chunks[0].concat_columns(chunks[1:])


def chunks_complete(storage, id_prefix: str, total_cols: int) -> bool:
    return all(
        storage.has_index(chunk_prefix(id_prefix, ci), 0)
        for ci in range(column_chunk_count(total_cols))
    )


def _gate_tags(gate_id: int) -> tuple[str, str]:
    return f"ggh15_gate_a_out_{gate_id}", f"ggh15_lut_u_g_matrix_{gate_id}"


def _v_tag(lut_id: int, k: int) -> str:
    return f"ggh15_lut_v_idx_{lut_id}_{k}"


def _gy_decomposed(params, d: int, y, device) -> PolyMatrix:
    """G^{-1}(G y) for the LUT output y."""
    gadget = PolyMatrix.gadget_matrix(params, d, device)
    return gadget.mul_poly_scalar(Poly.from_elem_to_constant(params, y, device)).decompose()


# ------------------------------------------------------------------ evaluators


@dataclass
class _GateState:
    lut_id: int
    input_pubkey: PolyMatrix


class GGH15BGGPubKeyPltEvaluator:
    """Offline (pubkey-path) evaluator with checkpoint-prefix resume."""

    def __init__(
        self,
        hash_key: bytes,
        d: int,
        trapdoor_sigma: float,
        error_sigma: float,
        dir_path,
        seed: int | None = None,
        mesh=None,
        device="cuda",
    ):
        self.hash_key = hash_key
        self.d = d
        self.trapdoor_sigma = trapdoor_sigma
        self.error_sigma = error_sigma
        self.dir_path = Path(dir_path)
        self.mesh = mesh  # offline preimage sampling shards over the mesh's col axis
        self.device = torch.device(device)
        self.lut_state: dict[int, PublicLut] = {}
        self.gate_state: dict[int, _GateState] = {}
        self._uniform = UniformSampler(seed, self.device)
        self._hash = HashSampler(self.device)

    # ---- deterministic ids

    def checkpoint_prefix(self, params) -> str:
        key_digest = hashlib.sha256(self.hash_key).hexdigest()[:16]
        return (
            f"ggh15_aux_n{params.n}_L{params.crt_depth}_crt{params.crt_bits}"
            f"_b{params.base_bits}_d{self.d}_ts{self.trapdoor_sigma}"
            f"_es{self.error_sigma}_ins0_key{key_digest}"
        )

    def _lut_aux_id(self, params, lut_id: int, x: int) -> str:
        # keyed by the entry INPUT x, not the output row k: see module doc
        return f"{self.checkpoint_prefix(params)}_lut_aux_{lut_id}_in{x}"

    def _gate_id_prefix(self, params, stage: str, gate_id: int) -> str:
        return f"{self.checkpoint_prefix(params)}_preimage_{stage}_{gate_id}"

    def _hash_mats(self, params, tags: list[str]) -> list[PolyMatrix]:
        """d x m_g hash matrices of `tags`, in one batch."""
        m_g = self.d * params.modulus_digits
        return self._hash.sample_hash_batch(params, self.hash_key, tags, self.d, m_g,
                                            FinRingDist())

    def _w_blocks(self, params, lut_id: int) -> list[PolyMatrix]:
        """W_id, W_gy, W_v, W_vx of a LUT in one batch."""
        return self._hash_mats(params, [f"ggh15_w_{lut_id}_{t}" for t in W_TAGS])

    def _a_out(self, params, gate_id: int) -> PolyMatrix:
        return self._hash_mats(params, [_gate_tags(gate_id)[0]])[0]

    def _error(self, params, nrow: int, ncol: int) -> PolyMatrix:
        if self.error_sigma <= 0.0:
            return PolyMatrix.zero(params, nrow, ncol, device=self.device)
        return self._uniform.sample_uniform(params, nrow, ncol, GaussDist(self.error_sigma))

    # ---- PltEvaluator surface (records state, returns hash-derived A_out)

    def public_lookup(self, params, plt, one, input_pk: BggPublicKey, gate_id, lut_id):
        self.lut_state.setdefault(lut_id, plt)
        self.gate_state[gate_id] = _GateState(lut_id, input_pk.matrix)
        return BggPublicKey(self._a_out(params, gate_id), True)

    # ---- trapdoor checkpoints

    def _load_trapdoor(self, params, name: str):
        cp = self.checkpoint_prefix(params)
        mat = read_matrix_from_multi_batch(params, self.dir_path, f"{cp}_{name}", 0, self.device)
        td_raw = read_bytes_from_multi_batch(self.dir_path, f"{cp}_{name}_trapdoor", 0)
        if mat is None or td_raw is None:
            return None
        return Trapdoor.from_compact_bytes(params, td_raw, self.device), mat

    def _store_trapdoor(self, params, name: str, trapdoor: Trapdoor, matrix: PolyMatrix):
        cp = self.checkpoint_prefix(params)
        add_lookup_buffer(get_lookup_buffer([(0, matrix)], f"{cp}_{name}"))
        add_lookup_buffer(
            get_lookup_buffer_bytes([(0, trapdoor.to_compact_bytes())], f"{cp}_{name}_trapdoor")
        )

    def load_b0_matrix_checkpoint(self, params) -> PolyMatrix | None:
        cp = self.checkpoint_prefix(params)
        return read_matrix_from_multi_batch(params, self.dir_path, f"{cp}_b0", 0, self.device)

    # ---- offline sampling

    def _trapdoor(self, params, trap_sampler, name: str):
        loaded = self._load_trapdoor(params, name)
        if loaded is not None:
            return loaded
        trapdoor, matrix = trap_sampler.trapdoor(params, self.d)
        self._store_trapdoor(params, name, trapdoor, matrix)
        return trapdoor, matrix

    def _lut_targets(self, params, lut_id: int, entries: list) -> list[PolyMatrix]:
        """Each entry's B1 target W_id + W_gy G^{-1}(G y) + W_v V_k + W_vx (V_k x).
        The distinct V_k are drawn and decomposed in batches of a bounded
        size, and W_vx (V_k x) is taken as (W_vx V_k) x (exact mod q)."""
        d = self.d
        m_g = d * params.modulus_digits
        L, n = params.crt_depth, params.n
        q = params.tables(self.device).moduli
        w_id, w_gy, w_v, w_vx = (w.to_eval() for w in self._w_blocks(params, lut_id))
        w_pair = torch.stack([w_v.data, w_vx.data])  # [2, L, d, m_g, n]
        rows = list(dict.fromkeys(k for _, (k, _) in entries))
        v_terms: dict[int, tuple[PolyMatrix, PolyMatrix]] = {}
        # keep each batch's decomposition [E, L, m_g, m_g, n] near 128M elements
        chunk = max(1, (128 << 20) // (L * m_g * m_g * n))
        for start in range(0, len(rows), chunk):
            ks = rows[start : start + chunk]
            v_raw = torch.stack([m.data for m in self._hash_mats(
                params, [_v_tag(lut_id, k) for k in ks])], dim=1)
            dec = decompose_rows(params, v_raw, COEFF)  # [E, L, m_g, m_g, n]
            E = len(ks)
            lhs = w_pair[:, None].expand(2, E, L, d, m_g, n)
            prod = zq_matmul(lhs, dec[None].expand(2, E, L, m_g, m_g, n), q)
            for i, k in enumerate(ks):
                v_terms[k] = (PolyMatrix(prod[0, i], EVAL, params),
                              PolyMatrix(prod[1, i], EVAL, params))
        gy_terms: dict[int, PolyMatrix] = {}
        targets = []
        for x, (k, y) in entries:
            if y.value not in gy_terms:
                gy_terms[y.value] = w_gy @ _gy_decomposed(params, d, y, self.device)
            v_term, vx_term = v_terms[k]
            x_poly = Poly.const(params, x, self.device)
            targets.append(w_id + gy_terms[y.value] + v_term + vx_term.mul_poly_scalar(x_poly))
        return targets

    def sample_aux_matrices(self, params):
        storage = get_storage_system()
        trap_sampler = TrapdoorSampler(params, self.trapdoor_sigma, device=self.device)
        d = self.d
        m_g = d * params.modulus_digits

        with span("ggh15.trapdoors"):
            b0_trapdoor, b0_matrix = self._trapdoor(params, trap_sampler, "b0")
            b1_trapdoor, b1_matrix = self._trapdoor(params, trap_sampler, "b1")

        gadget = PolyMatrix.gadget_matrix(params, d, self.device)

        # LUT preimages under B1 (resume row by row); pending entries share
        # the B1 trapdoor, so they go to the sampler as one chunked batch
        for lut_id, plt in list(self.lut_state.items()):
            pending = [(x, ky) for x, ky in plt.entries(params)
                       if not chunks_complete(storage, self._lut_aux_id(params, lut_id, x), m_g)]
            if pending:
                with span("ggh15.lut_targets", lut_id=lut_id, entries=len(pending)):
                    targets = self._lut_targets(params, lut_id, pending)
                with span("ggh15.preimages", stage="lut", requests=len(targets),
                          cols=sum(t.ncol for t in targets)):
                    preimages = trap_sampler.preimage_batched_chunked(
                        params, b1_trapdoor, b1_matrix, targets, mesh=self.mesh
                    )
                with span("ggh15.store", stage="lut", matrices=len(preimages)):
                    for (x, _), l_x in zip(pending, preimages):
                        store_matrix_chunked(l_x, self._lut_aux_id(params, lut_id, x))
                del targets, preimages
            self.lut_state.pop(lut_id)

        # gate preimages under B0 (resume stage by stage)
        for gate_id, state in list(self.gate_state.items()):
            w_id, w_gy, w_v, w_vx = self._w_blocks(params, state.lut_id)
            a_out, u_g = self._hash_mats(params, list(_gate_tags(gate_id)))
            s_g = self._uniform.sample_uniform(params, d, d, TernaryDist())

            stages = {
                "gate1": s_g @ b1_matrix + self._error(params, d, b1_matrix.ncol),
                "gate2_identity": s_g @ w_id + a_out + self._error(params, d, m_g),
                "gate2_gy": s_g @ w_gy - gadget + self._error(params, d, m_g),
                "gate2_v": s_g @ w_v - state.input_pubkey @ u_g.decompose()
                + self._error(params, d, m_g),
                "gate2_vx": s_g @ w_vx + u_g + self._error(params, d, m_g),
            }
            # the five stages share the B0 trapdoor: one batch
            prefixes, targets = [], []
            for stage, target in stages.items():
                prefix = self._gate_id_prefix(params, stage, gate_id)
                if chunks_complete(storage, prefix, target.ncol):
                    continue
                prefixes.append(prefix)
                targets.append(target)
            if targets:
                with span("ggh15.preimages", stage="gate", requests=len(targets),
                          cols=sum(t.ncol for t in targets)):
                    preimages = trap_sampler.preimage_batched_chunked(
                        params, b0_trapdoor, b0_matrix, targets, mesh=self.mesh
                    )
                with span("ggh15.store", stage="gate", matrices=len(preimages)):
                    for prefix, pre in zip(prefixes, preimages):
                        store_matrix_chunked(pre, prefix)
            self.gate_state.pop(gate_id)


class GGH15BGGPolyEncodingPltEvaluator:
    """Online GGH15 lookup over packed slot-wise encodings (reference
    ggh15/poly_encoding.rs): the stored chain is slot-independent; each slot
    decodes with its own c_b0 row and its own LUT row, and the slot rows are
    restacked under the shared hash-derived output pubkey."""

    def __init__(self, hash_key: bytes, dir_path, checkpoint_prefix: str, params,
                 c_b0_rows: PolyMatrix):
        self.scalar = GGH15BGGEncodingPltEvaluator(
            hash_key, dir_path, checkpoint_prefix, params, None
        )
        self.c_b0_rows = c_b0_rows  # S x m_b

    def public_lookup(self, params, plt, one, input_enc: BggPolyEncoding, gate_id, lut_id):
        if input_enc.plaintexts is None:
            raise ValueError("GGH15 lookup input must reveal its slot plaintexts")
        if self.c_b0_rows.nrow != input_enc.num_slots:
            raise ValueError(f"c_b0_rows has {self.c_b0_rows.nrow} rows for "
                             f"{input_enc.num_slots} slots")
        rows = []
        out_pk = None
        out_pts = []
        for s in range(input_enc.num_slots):
            self.scalar.c_b0 = self.c_b0_rows.slice_rows(s, s + 1)
            enc = BggEncoding(input_enc.vector(s), input_enc.pubkey, input_enc.plaintext(s))
            got = self.scalar.public_lookup(params, plt, None, enc, gate_id, lut_id)
            rows.append(got.vector)
            out_pk = got.pubkey
            out_pts.append(got.plaintext)
        return BggPolyEncoding(rows[0].concat_rows(rows[1:]), out_pk, tuple(out_pts))


class GGH15BGGEncodingPltEvaluator:
    """Online (encoding-path) evaluator reading stored preimage chains onto
    the device of c_b0."""

    def __init__(self, hash_key: bytes, dir_path, checkpoint_prefix: str, params,
                 c_b0: PolyMatrix | None):
        self.hash_key = hash_key
        self.dir_path = Path(dir_path)
        self.cp = checkpoint_prefix
        self.c_b0 = c_b0

    def _read_chunk(self, params, id_prefix: str, chunk_idx: int) -> PolyMatrix:
        m = read_matrix_from_multi_batch(
            params, self.dir_path, chunk_prefix(id_prefix, chunk_idx), 0, self.c_b0.data.device
        )
        if m is None:
            raise KeyError(f"missing GGH15 artifact {id_prefix} chunk {chunk_idx}")
        return m

    def _left_mul_chunked(self, params, left: PolyMatrix, id_prefix: str,
                          total_cols: int) -> PolyMatrix:
        """left @ stored, walking the stored column chunks (the products are
        queued on the device while the next chunk is read)."""
        outs = [
            left @ self._read_chunk(params, id_prefix, ci)
            for ci in range(column_chunk_count(total_cols))
        ]
        return outs[0] if len(outs) == 1 else outs[0].concat_columns(outs[1:])

    def public_lookup(self, params, plt, one, input_enc: BggEncoding, gate_id, lut_id):
        if input_enc.plaintext is None:
            raise ValueError("GGH15 lookup input must reveal its plaintext")
        x = input_enc.plaintext.const_value()
        got = plt.get(params, int(x))
        if got is None:
            raise KeyError(f"{x} not found in LUT {lut_id} for gate {gate_id}")
        k, y = got
        device = self.c_b0.data.device
        y_poly = Poly.from_elem_to_constant(params, y, device)
        d = input_enc.pubkey.matrix.nrow
        m_g = d * params.modulus_digits
        m_b = d * (params.modulus_digits + 2)

        a_out_tag, u_g_tag = _gate_tags(gate_id)
        a_out, u_g, v_raw = HashSampler(device).sample_hash_batch(
            params, self.hash_key, [a_out_tag, u_g_tag, _v_tag(lut_id, k)], d, m_g, FinRingDist()
        )
        v_k = v_raw.decompose()
        gy_dec = _gy_decomposed(params, d, y, device)

        def c_b0_times(stage: str, cols: int) -> PolyMatrix:
            return self._left_mul_chunked(params, self.c_b0,
                                          f"{self.cp}_preimage_{stage}_{gate_id}", cols)

        c = c_b0_times("gate2_identity", m_g)
        c = c + c_b0_times("gate2_gy", m_g) @ gy_dec
        c = c + c_b0_times("gate2_v", m_g) @ v_k
        c = c + c_b0_times("gate2_vx", m_g) @ v_k.mul_poly_scalar(input_enc.plaintext)
        c_p1 = c_b0_times("gate1", m_b)
        c = c - self._left_mul_chunked(params, c_p1, f"{self.cp}_lut_aux_{lut_id}_in{int(x)}",
                                       m_g)
        c = c + (input_enc.vector @ u_g.decompose()) @ v_k
        return BggEncoding(c, BggPublicKey(a_out, True), y_poly)
