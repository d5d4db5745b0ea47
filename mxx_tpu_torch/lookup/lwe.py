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
samples the K_high preimages and persists them to the artifact store. Online,
the encoding evaluator reads K_high(k) back onto the device of c_b,
re-derives K_low(k) from the hash, and outputs
c_out = c_b * K_high(k) + c_z * K_low(k), which encodes y_k under A_LT
(c_b = s*B is the evaluator's stored base encoding). Every matrix is made on
the device of the evaluator's operands.

Device batching (the JAX package works gate by gate; the bits are the
same): both evaluators compute in `public_lookup_batch`, for a circuit
level's LUT gates (one A_LT and one K_low hash batch, one pair of batched
products; `public_lookup` is a batch of one), and `sample_aux_matrices`
assembles the targets of many gates together and hands them to the
preimage sampler in shared calls, since every K_high row is a preimage
under the one (B, T). A protocol such as Diamond iO
records thousands of small LUT gates; per gate, the host work of each call
would dominate. Artifact names, row bytes and the relation B K_high = target
are those of the per-gate pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..matrix.offload import offload_matrix
from ..matrix.rows import decompose as decompose_rows
from ..matrix.rows import unstack as unstack_rows
from ..ops.elementwise import ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import COEFF, EVAL, Poly, residue_planes_from_ints
from ..sampler import FinRingDist, HashSampler, Trapdoor, TrapdoorSampler
from ..storage import add_lookup_buffer, get_lookup_buffer_stacked, read_matrix_from_multi_batch
from ..utils.tracing import span
from .public_lut import PublicLut, lut_input_values

# the preimage output bytes (int64 on the device) that one shared K_high
# preimage call may reach; never fewer LUT entries per call than
# LUT_PREIMAGE_CHUNK_SIZE (at n=2^13, L=8 one entry's K_high is 151 MB, so
# the chunk size rules there, as in the per-gate pass). 128 MiB is a bound
# on device memory, not a tuned optimum: a call's working set (targets,
# float perturbations, output) is a small multiple of its output, and the
# n=4, L=3 Diamond iO obfuscation peaks at 0.9-1.9 GiB of device memory with
# it. Its 2.8 million K_high rows (1,440 B of output each) then take 33
# calls, and the 4.4-6.8 s these calls take on the card are sampling work:
# a larger bound would only cut the calls' small fixed host cost.
PREIMAGE_CALL_BYTES = 1 << 27


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


def _a_lt_entry(params, row_size, hash_key, gate_ids, slot_idx, context, device, slot_idxs):
    """The cache entry [A_LT stack, bytes, per-gate views or None] of a
    batch of gates, derived on a miss."""
    device = torch.device(device)
    slots = [s or 0 for s in slot_idxs] if slot_idxs is not None else [slot_idx or 0] * len(gate_ids)
    ck = (params.n, params.crt_depth, params.crt_bits, params.base_bits, row_size, hash_key,
          tuple(slots), context, tuple(gate_ids), str(device))
    hit = _A_LT_CACHE.get(ck)
    if hit is not None:
        return hit
    m_g = row_size * params.modulus_digits
    tags = [f"A_LT_{_ctx_tag(context)}{g}_slot{s}" for g, s in zip(gate_ids, slots)]
    out = HashSampler(device).sample_hash_stacked(params, hash_key, tags, row_size, m_g,
                                                  FinRingDist(), eval_form=True)
    entry = [out, out.numel() * out.element_size(), None]
    if entry[1] <= _A_LT_CACHE_LIMIT:
        while _A_LT_CACHE and _A_LT_CACHE_BYTES[0] + entry[1] > _A_LT_CACHE_LIMIT:
            _A_LT_CACHE_BYTES[0] -= _A_LT_CACHE.pop(next(iter(_A_LT_CACHE)))[1]
        _A_LT_CACHE[ck] = entry
        _A_LT_CACHE_BYTES[0] += entry[1]
    return entry


def derive_a_lt_stacked(params, row_size: int, hash_key: bytes, gate_ids: list[int],
                        slot_idx=None, context: str = "", device="cuda",
                        slot_idxs: list | None = None) -> torch.Tensor:
    """Many gates' A_LT as one [L, B, row_size, m, n] EVAL tensor, from one
    batch of hash lanes and one transform, equal per gate to
    `derive_a_lt_matrix` (same tags and streams); `slot_idxs` gives each gate
    its own slot (vec wires). Results are kept in a bounded FIFO cache,
    since a protocol derives the same hash-determined A_LT once per pass;
    nothing writes into a cached tensor."""
    return _a_lt_entry(params, row_size, hash_key, gate_ids, slot_idx, context, device,
                       slot_idxs)[0]


def derive_a_lt_matrices_batch(params, row_size: int, hash_key: bytes, gate_ids: list[int],
                               slot_idx=None, context: str = "",
                               device="cuda", slot_idxs: list | None = None) -> list[PolyMatrix]:
    """`derive_a_lt_stacked` as one EVAL matrix per gate (views, made once
    per cache entry)."""
    entry = _a_lt_entry(params, row_size, hash_key, gate_ids, slot_idx, context, device,
                        slot_idxs)
    if entry[2] is None:
        entry[2] = unstack_rows(params, entry[0])
    return list(entry[2])


def _k_low_tag(gate_id: int, lut_id: int, lut_entry_idx: int, slot_idx=None,
               context: str = "") -> str:
    return (f"LWE_R_G_{_ctx_tag(context)}{gate_id}_{lut_id}_{lut_entry_idx}"
            f"_slot{slot_idx or 0}")


def derive_k_low(params, row_size: int, hash_key: bytes, gate_id: int, lut_id: int,
                 lut_entry_idx: int, slot_idx=None, context: str = "",
                 device="cuda") -> PolyMatrix:
    """One entry's K_low in COEFF form, as the JAX package returns it. Kept
    beside `derive_k_lows_batch`, whose EVAL output would cost a single
    entry two more transforms (a forward, then the inverse)."""
    m_g = row_size * params.modulus_digits
    raw = HashSampler(device).sample_hash(
        params, hash_key, _k_low_tag(gate_id, lut_id, lut_entry_idx, slot_idx, context),
        row_size, m_g, FinRingDist(),
    )
    return raw.decompose()


def derive_k_lows_batch(params, row_size: int, hash_key: bytes, tags: list[str],
                        device="cuda") -> torch.Tensor:
    """K_low of many (gate, entry) tags in one hash batch and one batched
    decomposition: [E, L, m_g, m_g, n] in EVAL form, equal per tag to
    `derive_k_low`."""
    m_g = row_size * params.modulus_digits
    raw = HashSampler(device).sample_hash_stacked(params, hash_key, tags, row_size, m_g,
                                                  FinRingDist())
    return decompose_rows(params, raw, COEFF)


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
        self.mesh = mesh  # offline K_high sampling shards over the mesh's col axis
        self.context: str = ""  # per-circuit namespace (set_plt_context)
        self.gate_state: dict[tuple[str, int, int], _GateState] = {}
        self.last_offloaded_targets = 0

    def public_lookup(self, params, plt: PublicLut, one, input_pk: BggPublicKey,
                      gate_id: int, lut_id: int, slot_idx=None) -> BggPublicKey:
        """One gate through `public_lookup_batch`; A_LT in COEFF form, as the
        JAX package returns it."""
        out = self.public_lookup_batch(params, [(plt, input_pk, gate_id, lut_id)], [slot_idx])
        return BggPublicKey(out[0].matrix.to_coeff(), True)

    def public_lookup_batch(self, params, items, slot_idxs=None) -> list[BggPublicKey]:
        """items = [(plt, input_pk, gate_id, lut_id)], `slot_idxs` one slot
        per item or None: one A_LT batch; each gate's input pubkey and A_LT
        are recorded for `sample_aux_matrices`."""
        d = items[0][1].matrix.nrow
        if any(it[1].matrix.nrow != d for it in items):
            raise ValueError("a LUT batch takes input pubkeys with one row count")
        ctx = self.context
        slots = slot_idxs if slot_idxs is not None else [None] * len(items)
        a_lts = derive_a_lt_matrices_batch(params, d, self.hash_key, [it[2] for it in items],
                                           context=ctx, device=items[0][1].matrix.data.device,
                                           slot_idxs=slot_idxs)
        for (plt, input_pk, gate_id, lut_id), slot, a_lt in zip(items, slots, a_lts):
            self.gate_state[(ctx, gate_id, slot or 0)] = _GateState(
                lut_id, input_pk.matrix, a_lt, plt, ctx)
        return [BggPublicKey(a, True) for a in a_lts]

    def _entries_per_call(self, params) -> int:
        d = self.pub_matrix.nrow
        k = params.modulus_digits
        entry_bytes = (k + 2) * d * d * k * params.crt_depth * params.n * 8
        return max(config.lut_preimage_chunk_size(), PREIMAGE_CALL_BYTES // entry_bytes)

    def sample_aux_matrices(self, params):
        """Sample and persist the K_high preimage rows of every recorded gate.

        Gates are taken in recording order, in groups of at most one call's
        entries (`_entries_per_call`; a larger gate is a group alone). A
        group's targets are assembled together; each gate's entries form
        requests of at most that many entries (one column block per entry),
        and the preimage calls take whole requests up to that many entries.
        Each gate's rows are stored as its own buffer."""
        with span("lwe_lut.sample_aux_matrices", gates=len(self.gate_state)):
            per_call = self._entries_per_call(params)
            tables: dict = {}  # id(plt) -> its entries; gates share a few tables
            group: list = []
            size = 0
            for key, state in list(self.gate_state.items()):
                entries = tables.get(id(state.plt))
                if entries is None:
                    entries = tables[id(state.plt)] = list(state.plt.entries(params))
                if group and size + len(entries) > per_call:
                    self._sample_group(params, group, per_call)
                    group, size = [], 0
                group.append((key, state, entries))
                size += len(entries)
            if group:
                self._sample_group(params, group, per_call)
            self.gate_state.clear()

    def _sample_group(self, params, group, per_call: int):
        requests = [(gi, a, min(a + per_call, len(entries)))
                    for gi, (_, _, entries) in enumerate(group)
                    for a in range(0, len(entries), per_call)]
        with span("lwe_lut.k_high_targets", gates=len(group),
                  entries=sum(len(e) for _, _, e in group)):
            targets = self._targets_many(params, group, requests)
        most = max(b - a for _, a, b in requests)
        with span("lwe_lut.k_high_preimages", gates=len(group), requests=len(targets),
                  cols=sum(t.ncol for t in targets)):
            outs = self.trap_sampler.preimage_batched_chunked(
                params, self.trapdoor, self.pub_matrix, targets, mesh=self.mesh,
                chunk=max(1, per_call // most))
        for t in targets:
            if hasattr(t, "delete"):
                t.delete()
        del targets
        m_g = self.pub_matrix.nrow * params.modulus_digits
        by_gate: dict = {}
        for (gi, a, b), out in zip(requests, outs):
            L, R, _, n = out.data.shape
            # the request's entries, each its own [L, R, m_g, n] K_high
            by_gate.setdefault(gi, []).append(
                out.data.reshape(L, R, b - a, m_g, n).permute(2, 0, 1, 3, 4))
        for gi, ((ctx, gate_id, slot_idx), st, entries) in enumerate(group):
            add_lookup_buffer(get_lookup_buffer_stacked(
                params, outs[0].fmt, [int(kk) for _, (kk, _) in entries], by_gate.pop(gi),
                k_high_checkpoint_prefix(gate_id, st.lut_id, slot_idx, ctx)))

    def _k_high_targets(self, params, plt, a_z, a_lt, gate_id, lut_id, slot_idx,
                        context="") -> list:
        """Every LUT entry's preimage target A_LT - G*y - (A_z - G*x) @ K_low
        of one gate, in entry order, one [d, m_g] matrix each (see
        `_targets_many`)."""
        entries = list(plt.entries(params))
        group = [((context, gate_id, slot_idx or 0), _GateState(lut_id, a_z, a_lt, plt, context),
                  entries)]
        return self._targets_many(params, group, [(0, e, e + 1) for e in range(len(entries))])

    def _targets_many(self, params, group, requests) -> list:
        """The preimage targets of the gates in `group` ([(key, _GateState,
        entries)]) for `requests` ([(gate index, first entry, end entry)],
        in gate and entry order): each request's entries side by side, one
        [d, m_g] column block each, in EVAL form. They are assembled in
        batched chunks that may span gates: one hash batch for the chunk's
        K_low, one batched decomposition, one batched matmul, elementwise
        the rest. Once the targets exceed MXX_OFFLOAD_BUDGET_BYTES of device
        memory, further ones spill to host memmaps (`OffloadedMatrix`),
        which the chunked preimage rehydrates."""
        d = self.pub_matrix.nrow
        m_g = d * params.modulus_digits
        n, L = params.n, params.crt_depth
        device = self.pub_matrix.data.device
        q = params.tables(device).moduli

        g_eval = PolyMatrix.gadget_matrix(params, d, device).data  # [L, d, m_g, n]
        # every gate's A_z and A_LT, stacked: [L, G, d, m_g, n]
        az_eval = torch.stack([st.input_pubkey.to_eval().data for _, st, _ in group], dim=1)
        alt_eval = torch.stack([st.output_pubkey.to_eval().data for _, st, _ in group], dim=1)
        flat = [(gi, int(x), int(y.value), _k_low_tag(gate_id, st.lut_id, int(kk), slot, ctx))
                for gi, ((ctx, gate_id, slot), st, entries) in enumerate(group)
                for x, (kk, y) in entries]

        # assembly chunk: keep the batched decomposition [L, E*m_g, m_g, n]
        # under ~64M elements (E = 4 at n = 2^13, L = 8, m_g = 16)
        chunk_e = max(1, (64 << 20) // (L * m_g * m_g * n))

        def assemble(chunk):
            """[L, d, E*m_g, n]: the chunk's targets side by side."""
            E = len(chunk)
            dec = derive_k_lows_batch(params, d, self.hash_key, [c[3] for c in chunk],
                                      device)  # [E, L, m_g, m_g, n]

            def scal(values):
                # constant polys are slot-constant in EVAL form: [L, E*d, 1, 1]
                res = torch.from_numpy(residue_planes_from_ints(params, values).astype(np.int64))
                return res.to(device).repeat_interleave(d, dim=1)[:, :, None, None]

            gidx = torch.tensor([c[0] for c in chunk], dtype=torch.int64, device=device)
            g_t = g_eval.repeat(1, E, 1, 1)  # [L, E*d, m_g, n]
            gx = ew_mul(g_t, scal([c[1] for c in chunk]), q)
            gy = ew_mul(g_t, scal([c[2] for c in chunk]), q)
            ext = ew_sub(az_eval[:, gidx].reshape(L, E * d, m_g, n), gx, q)
            tgt = ew_sub(alt_eval[:, gidx].reshape(L, E * d, m_g, n), gy, q)
            prod = zq_matmul(ext.reshape(L, E, d, m_g, n).transpose(0, 1), dec, q)
            adj = ew_sub(tgt, prod.transpose(0, 1).reshape(L, E * d, m_g, n), q)
            return adj.reshape(L, E, d, m_g, n).permute(0, 2, 1, 3, 4).reshape(L, d, E * m_g, n)

        chunks = (assemble(flat[i : i + chunk_e]) for i in range(0, len(flat), chunk_e))
        budget = config.offload_budget_bytes()
        entry_bytes = L * d * m_g * n * 8
        targets = []
        pending: list = []  # assembled columns not yet handed to a request
        have = 0
        live_bytes = 0
        self.last_offloaded_targets = 0
        for _, a, b in requests:
            need = (b - a) * m_g
            while have < need:
                pending.append(next(chunks))
                have += pending[-1].shape[2]
            data = torch.cat(pending, dim=2) if len(pending) > 1 else pending[0]
            pending = [data[:, :, need:]] if have > need else []
            have -= need
            t = PolyMatrix(data[:, :, :need], EVAL, params)
            if budget and live_bytes + (b - a) * entry_bytes > budget:
                targets.append(offload_matrix(t))
                self.last_offloaded_targets += b - a
            else:
                targets.append(t)
                live_bytes += (b - a) * entry_bytes
        return targets


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
        """One gate through `public_lookup_batch`; A_LT in COEFF form, as the
        JAX package returns it."""
        out = self.public_lookup_batch(params, [(plt, input_enc, gate_id, lut_id)],
                                       [slot_idx])[0]
        return BggEncoding(out.vector, BggPublicKey(out.pubkey.matrix.to_coeff(), True),
                           out.plaintext)

    def public_lookup_batch(self, params, items, slot_idxs=None) -> list[BggEncoding]:
        """items = [(plt, input_enc, gate_id, lut_id)], `slot_idxs` one slot
        per item or None: one read of the inputs' constants, one A_LT and
        one K_low hash batch, each gate's K_high row read from the store,
        and c_b K_high + c_z K_low as two batched products."""
        device = self.c_b.data.device
        d = items[0][1].pubkey.matrix.nrow
        if any(it[1].pubkey.matrix.nrow != d for it in items):
            raise ValueError("a LUT batch takes input encodings with one row count")
        ctx = self.context
        slots = slot_idxs if slot_idxs is not None else [None] * len(items)
        zs = lut_input_values(params, [it[1].plaintext for it in items])
        rows, y_vals, k_highs = [], [], []
        with span("lwe_lut.k_high_reads", gates=len(items)):
            for (plt, _, gate_id, lut_id), slot, z in zip(items, slots, zs):
                got = plt.get(params, z)
                if got is None:
                    raise KeyError(f"{z} does not exist in public lookup table {lut_id}")
                k, y_k = got
                k_high = read_matrix_from_multi_batch(
                    params, self.dir_path, k_high_checkpoint_prefix(gate_id, lut_id, slot, ctx),
                    k, device)
                if k_high is None:
                    raise KeyError(f"missing stored K_high for gate {gate_id} row {k} "
                                   f"ctx={ctx!r}")
                rows.append(int(k))
                y_vals.append(int(y_k.value))
                k_highs.append(k_high.to_eval().data)
        a_lts = derive_a_lt_matrices_batch(params, d, self.hash_key, [it[2] for it in items],
                                           context=ctx, device=device, slot_idxs=slot_idxs)
        k_lows = derive_k_lows_batch(params, d, self.hash_key, [
            _k_low_tag(gate_id, lut_id, k, slot, ctx)
            for (_, _, gate_id, lut_id), slot, k in zip(items, slots, rows)], device)
        q = params.tables(device).moduli
        B = len(items)
        c_b = self.c_b.to_eval().data
        c_z = torch.stack([it[1].vector.to_eval().data for it in items])  # [B, L, 1, m_g, n]
        high = zq_matmul(c_b.expand((B,) + tuple(c_b.shape)), torch.stack(k_highs), q)
        low = zq_matmul(c_z, k_lows, q)
        vec = torch.remainder(high + low, q.view(-1, 1, 1, 1))  # [B, L, 1, m_g, n]
        y_res = torch.from_numpy(residue_planes_from_ints(params, y_vals).astype(np.int64))
        y_res = y_res.to(device)  # [L, B]
        L = params.crt_depth
        return [
            BggEncoding(PolyMatrix(vec[i], EVAL, params), BggPublicKey(a_lts[i], True),
                        Poly(y_res[:, i : i + 1].expand(L, params.n).contiguous(), EVAL, params))
            for i in range(B)
        ]
