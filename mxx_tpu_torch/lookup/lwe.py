"""LWE public lookup-table evaluators over BGG+ wires.

The port's counterpart of `mxx_tpu/lookup/lwe.py`. For a gate g with input
pubkey A_z and hash-derived output pubkey A_LT, each LUT entry
(x_k -> row k, y_k) gets:

    ext      = A_z  - G * x_k
    target   = A_LT - G * y_k
    K_low(k) = HashDecomposed(key, "LWE_R_G_{gate}_{lut}_{k}_slot{s}")
    K_high(k)= Preimage_{B,T}(target - ext * K_low(k))

Offline, the pubkey evaluator records gate states during circuit evaluation
and `sample_aux_matrices` assembles every entry's target (`_k_high_targets`),
samples the K_high preimages in request chunks and persists them to the
artifact store. Online, the encoding evaluator reads K_high(k) back onto the
device of c_b, re-derives K_low(k) from the hash, and outputs
c_out = c_b * K_high(k) + c_z * K_low(k), which encodes y_k under A_LT
(c_b = s*B is the evaluator's stored base encoding). Every matrix is made on
the device of the evaluator's operands.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from ..circuit.batched_eval import _batched_decompose
from ..matrix import PolyMatrix
from ..matrix.offload import offload_matrix
from ..ops.elementwise import ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import EVAL, Poly, residue_planes_from_ints
from ..sampler import FinRingDist, HashSampler, Trapdoor, TrapdoorSampler
from ..storage import add_lookup_buffer, get_lookup_buffer, read_matrix_from_multi_batch
from ..utils.tracing import span
from .public_lut import PublicLut


def _ctx_tag(context: str) -> str:
    # an empty context keeps the single-circuit tag and prefix formats
    return f"{context}|" if context else ""


def derive_a_lt_matrix(params, row_size: int, hash_key: bytes, gate_id: int, slot_idx=None,
                       context: str = "", device="cuda") -> PolyMatrix:
    m_g = row_size * params.modulus_digits
    tag = f"A_LT_{_ctx_tag(context)}{gate_id}_slot{slot_idx or 0}"
    return HashSampler(device).sample_hash(params, hash_key, tag, row_size, m_g, FinRingDist())


_A_LT_CACHE: dict = {}
_A_LT_CACHE_BYTES = [0]
_A_LT_CACHE_LIMIT = 1 << 28  # 256 MB of device tensors; FIFO-evicted


def derive_a_lt_matrices_batch(params, row_size: int, hash_key: bytes, gate_ids: list[int],
                               slot_idx=None, context: str = "",
                               device="cuda", slot_idxs: list | None = None) -> list[PolyMatrix]:
    """Many gates' A_LT (EVAL form) in one batch of hash lanes and one
    transform, equal per gate to `derive_a_lt_matrix` (same tags and
    streams); `slot_idxs` gives each gate its own slot (vec wires). Results
    are kept in a bounded FIFO cache, since a protocol derives the same
    hash-determined A_LT once per pass; nothing writes into a cached
    tensor."""
    device = torch.device(device)
    slots = [s or 0 for s in slot_idxs] if slot_idxs is not None else [slot_idx or 0] * len(gate_ids)
    ck = (params.n, params.crt_depth, params.crt_bits, params.base_bits, row_size, hash_key,
          tuple(slots), context, tuple(gate_ids), str(device))
    hit = _A_LT_CACHE.get(ck)
    if hit is not None:
        return list(hit[0])
    m_g = row_size * params.modulus_digits
    tags = [f"A_LT_{_ctx_tag(context)}{g}_slot{s}" for g, s in zip(gate_ids, slots)]
    out = HashSampler(device).sample_hash_batch(params, hash_key, tags, row_size, m_g,
                                                FinRingDist(), eval_form=True)
    nbytes = sum(m.data.numel() * m.data.element_size() for m in out)
    if nbytes <= _A_LT_CACHE_LIMIT:
        while _A_LT_CACHE and _A_LT_CACHE_BYTES[0] + nbytes > _A_LT_CACHE_LIMIT:
            _, old_bytes = _A_LT_CACHE.pop(next(iter(_A_LT_CACHE)))
            _A_LT_CACHE_BYTES[0] -= old_bytes
        _A_LT_CACHE[ck] = (out, nbytes)
        _A_LT_CACHE_BYTES[0] += nbytes
    return list(out)


def _k_low_tag(gate_id: int, lut_id: int, lut_entry_idx: int, slot_idx=None,
               context: str = "") -> str:
    return (f"LWE_R_G_{_ctx_tag(context)}{gate_id}_{lut_id}_{lut_entry_idx}"
            f"_slot{slot_idx or 0}")


def derive_k_low(params, row_size: int, hash_key: bytes, gate_id: int, lut_id: int,
                 lut_entry_idx: int, slot_idx=None, context: str = "",
                 device="cuda") -> PolyMatrix:
    m_g = row_size * params.modulus_digits
    raw = HashSampler(device).sample_hash(
        params, hash_key, _k_low_tag(gate_id, lut_id, lut_entry_idx, slot_idx, context),
        row_size, m_g, FinRingDist(),
    )
    return raw.decompose()


def k_high_checkpoint_prefix(gate_id: int, lut_id: int, slot_idx=None, context: str = "") -> str:
    ctx = context.replace("/", ".") if context else ""
    return f"LWE_K_H_{ctx + '.' if ctx else ''}{gate_id}_{lut_id}_slot{slot_idx or 0}"


def set_plt_context(evaluator, context: str) -> None:
    """Namespace the storage-backed LUT evaluator for the NEXT circuit eval.

    Gate and lut ids are per circuit (gate 0 restarts in every PolyCircuit),
    but a protocol evaluates many circuits through one evaluator instance:
    without a namespace the recorded gate states and the persisted K_high
    artifacts of two circuits collide. Both sides of a protocol must set the
    same context string around the matching circuit eval. No-op for
    evaluators without a `context` attribute (nothing persisted)."""
    seen = set()
    while evaluator is not None and id(evaluator) not in seen:
        seen.add(id(evaluator))
        if hasattr(evaluator, "context"):
            evaluator.context = context
        # unwrap slotwise / vec wrappers
        evaluator = getattr(evaluator, "scalar", None)


@dataclass
class _GateState:
    lut_id: int
    input_pubkey: PolyMatrix
    output_pubkey: PolyMatrix
    plt: PublicLut = None
    context: str = ""


class LWEBGGPubKeyPltEvaluator:
    """Offline (pubkey-path) evaluator. Targets, preimages and K_high live
    on the device of `pub_matrix`."""

    def __init__(self, hash_key: bytes, trap_sampler: TrapdoorSampler, pub_matrix: PolyMatrix,
                 trapdoor: Trapdoor, dir_path, mesh=None):
        self.hash_key = hash_key
        self.trap_sampler = trap_sampler
        self.pub_matrix = pub_matrix
        self.trapdoor = trapdoor
        self.dir_path = Path(dir_path)
        self.mesh = mesh  # passed on to the preimage sampler, which raises on a mesh
        self.context: str = ""  # per-circuit namespace (set_plt_context)
        self.gate_state: dict[tuple[str, int, int], _GateState] = {}
        self.last_offloaded_targets = 0

    def public_lookup(self, params, plt: PublicLut, one, input_pk: BggPublicKey,
                      gate_id: int, lut_id: int, slot_idx=None) -> BggPublicKey:
        row_size = input_pk.matrix.nrow
        ctx = self.context
        a_lt = derive_a_lt_matrix(params, row_size, self.hash_key, gate_id, slot_idx, ctx,
                                  device=input_pk.matrix.data.device)
        self.gate_state[(ctx, gate_id, slot_idx or 0)] = _GateState(
            lut_id, input_pk.matrix, a_lt, plt, ctx
        )
        return BggPublicKey(a_lt, True)

    def sample_aux_matrices(self, params):
        """Sample and persist the K_high preimage rows of every recorded gate."""
        with span("lwe_lut.sample_aux_matrices", gates=len(self.gate_state)):
            for (ctx, gate_id, slot_idx), state in list(self.gate_state.items()):
                with span("lwe_lut.k_high_gate", gate_id=gate_id, slot=slot_idx, ctx=ctx):
                    buffer = self._sample_k_high_buffer(
                        params, state.plt, state.input_pubkey, state.output_pubkey,
                        gate_id, state.lut_id, slot_idx, ctx,
                    )
                add_lookup_buffer(buffer)
            self.gate_state.clear()

    def _k_high_targets(self, params, plt, a_z, a_lt, gate_id, lut_id, slot_idx,
                        context="") -> list:
        """Every LUT entry's preimage target A_LT - G*y - (A_z - G*x) @ K_low,
        in entry order, as EVAL views of a few batched chunks: one hash batch
        for the chunk's K_low, one batched decomposition, one batched matmul,
        elementwise the rest. Once the targets exceed MXX_OFFLOAD_BUDGET_BYTES
        of device memory, further ones spill to host memmaps
        (`OffloadedMatrix`), which the chunked preimage rehydrates."""
        d = self.pub_matrix.nrow
        m_g = d * params.modulus_digits
        n, L = params.n, params.crt_depth
        device = self.pub_matrix.data.device
        q = params.tables(device).moduli
        sampler = HashSampler(device)
        entries = list(plt.entries(params))

        g_eval = PolyMatrix.gadget_matrix(params, d, device).data  # [L, d, m_g, n]
        az_eval = a_z.to_eval().data
        alt_eval = a_lt.to_eval().data

        # assembly chunk: keep the batched decomposition [L, E*m_g, m_g, n]
        # under ~64M elements (E = 4 at n = 2^13, L = 8, m_g = 16)
        chunk_e = max(1, (64 << 20) // (L * m_g * m_g * n))

        def assemble(chunk):
            E = len(chunk)
            k_low_raw = sampler.sample_hash_batch(
                params, self.hash_key,
                [_k_low_tag(gate_id, lut_id, int(kk), slot_idx, context) for _, (kk, _) in chunk],
                d, m_g, FinRingDist(),
            )
            dec = _batched_decompose(params, k_low_raw)  # [E, L, m_g, m_g, n]

            def scal(values):
                # constant polys are slot-constant in EVAL form: [L, E*d, 1, 1]
                res = torch.from_numpy(residue_planes_from_ints(params, values).astype(np.int64))
                return res.to(device).repeat_interleave(d, dim=1)[:, :, None, None]

            g_t = g_eval.repeat(1, E, 1, 1)  # [L, E*d, m_g, n]
            gx = ew_mul(g_t, scal([int(x) for x, _ in chunk]), q)
            gy = ew_mul(g_t, scal([int(y.value) for _, (_, y) in chunk]), q)
            ext = ew_sub(az_eval.repeat(1, E, 1, 1), gx, q)
            tgt = ew_sub(alt_eval.repeat(1, E, 1, 1), gy, q)
            prod = zq_matmul(ext.reshape(L, E, d, m_g, n).transpose(0, 1), dec, q)
            adj = ew_sub(tgt, prod.transpose(0, 1).reshape(L, E * d, m_g, n), q)
            return [PolyMatrix(adj[:, i * d : (i + 1) * d], EVAL, params) for i in range(E)]

        budget = config.offload_budget_bytes()
        entry_bytes = L * d * m_g * n * 8
        targets = []
        live_bytes = 0
        self.last_offloaded_targets = 0
        for start in range(0, len(entries), chunk_e):
            for t in assemble(entries[start : start + chunk_e]):
                if budget and live_bytes + entry_bytes > budget:
                    targets.append(offload_matrix(t))
                    self.last_offloaded_targets += 1
                else:
                    targets.append(t)
                    live_bytes += entry_bytes
        return targets

    def _sample_k_high_buffer(self, params, plt, a_z, a_lt, gate_id, lut_id, slot_idx,
                              context=""):
        """The gate's K_high rows as a storage buffer: targets, then the
        chunked preimages (all rows share (B, T)), then one device-to-host
        copy of the rows."""
        entries = list(plt.entries(params))
        with span("lwe_lut.k_high_targets", entries=len(entries)):
            targets = self._k_high_targets(params, plt, a_z, a_lt, gate_id, lut_id, slot_idx,
                                           context)
        with span("lwe_lut.k_high_preimages", requests=len(targets),
                  cols=sum(t.ncol for t in targets)):
            k_highs = self.trap_sampler.preimage_batched_chunked(
                params, self.trapdoor, self.pub_matrix, targets, mesh=self.mesh
            )
        for t in targets:
            if hasattr(t, "delete"):
                t.delete()
        rows = [(int(kk), kh) for (_, (kk, _)), kh in zip(entries, k_highs)]
        return get_lookup_buffer(rows, k_high_checkpoint_prefix(gate_id, lut_id, slot_idx,
                                                                context))


class LWEBGGEncodingPltEvaluator:
    """Online (encoding-path) evaluator. K_high is read onto the device of
    `c_b`, where the output is computed."""

    def __init__(self, hash_key: bytes, dir_path, c_b: PolyMatrix):
        self.hash_key = hash_key
        self.dir_path = Path(dir_path)
        self.c_b = c_b
        self.context: str = ""  # per-circuit namespace (set_plt_context)

    def public_lookup(self, params, plt: PublicLut, one, input_enc: BggEncoding,
                      gate_id: int, lut_id: int, slot_idx=None) -> BggEncoding:
        if input_enc.plaintext is None:
            raise ValueError("LWE lookup input must reveal its plaintext")
        z = input_enc.plaintext.const_value()
        got = plt.get(params, int(z))
        if got is None:
            raise KeyError(f"{z} does not exist in public lookup table {lut_id}")
        k, y_k = got
        device = self.c_b.data.device
        y_poly = Poly.from_elem_to_constant(params, y_k, device)
        row_size = input_enc.pubkey.matrix.nrow
        ctx = self.context
        a_lt = derive_a_lt_matrix(params, row_size, self.hash_key, gate_id, slot_idx, ctx,
                                  device=device)
        k_high = read_matrix_from_multi_batch(
            params, self.dir_path, k_high_checkpoint_prefix(gate_id, lut_id, slot_idx, ctx), k,
            device,
        )
        if k_high is None:
            raise KeyError(f"missing stored K_high for gate {gate_id} row {k} ctx={ctx!r}")
        k_low = derive_k_low(params, row_size, self.hash_key, gate_id, lut_id, k, slot_idx, ctx,
                             device=device)
        vector = self.c_b @ k_high + input_enc.vector @ k_low
        return BggEncoding(vector, BggPublicKey(a_lt, True), y_poly)
