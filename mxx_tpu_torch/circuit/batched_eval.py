"""Level-batched circuit evaluation over BGG wires.

The port's counterpart of `mxx_tpu/circuit/batched_eval.py`. Gates are walked
level by level; same-kind same-shape gates within a level collapse into one
batched op over stacked operands (`Rows`: [L, B, r, c, n] tensors). Each
kind is written once, in `gate_rows`, over the exact ops (`ew_*`,
`zq_matmul`, `digit_decompose`, `ntt_*_auto`), so batched results are
bit-identical to sequential ones; the arena evaluator runs the same
function over the rows it gathers.

Batched kinds: Add/Sub/Mul/SmallScalarMul/LargeScalarMul over
BggEncoding/BggPublicKey wires, and over their vec wires
(`BGGPublicKeyVec`/`BGGEncodingVec`), whose slots are independent for these
kinds: a level's vec gates become one scalar batch of (gate, slot) stand-ins,
and each gate's output vec is regrouped from its slots' results. PubLut gates
go to the evaluator's `public_lookup_batch` when it has one (vec wires
through `SlotwisePltEvaluator`). Everything else (slot gates, sub-circuit
calls, foreign wire types) goes through the sequential per-gate dispatch
inside the same level walk, so `eval_batched` accepts any circuit `eval`
accepts.

A batch is cut into parts whose wires fit `config.lut_bytes_limit()`, the
bound the port puts on one buffer: a level of a nested-RNS circuit holds
about a thousand same-kind gates, and one op over all of them at n=2^13, L=8
would need several times their 8-16 GB in temporaries. Parts give the same
bits, and each part's inputs are released before the next part runs.

A circuit whose wires are all scalar public keys or all scalar encodings of
one shape, and whose gates are all batchable kinds or PubLut, goes to the
arena evaluator (`arena_eval.py`) unless a live-bytes budget is set: no wire
object exists there between the inputs and the outputs, so the per-gate
host work of multi-million-gate PRG circuits is index bookkeeping.

Results stay on the device: each gate's output is a view of its batch's
result tensor. The batched decomposition transforms through `ntt_inv_auto` /
`ntt_fwd_auto`, so on a card it runs the four-step kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from ..bgg.vec import BGGEncodingVec, BGGPublicKeyVec
from ..matrix import PolyMatrix
from ..matrix.rows import decompose as decompose_rows
from ..matrix.rows import stack as stack_rows
from ..ops.elementwise import ew_add, ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.poly import EVAL, Poly, scalar_poly
from .gate import ADD, INPUT, LARGE_SCALAR_MUL, MUL, PUB_LUT, SMALL_SCALAR_MUL, SUB, Gate

MIN_BATCH = 3

_BATCHABLE = {ADD, SUB, MUL, SMALL_SCALAR_MUL, LARGE_SCALAR_MUL}


def _is_bgg(w) -> bool:
    return isinstance(w, (BggEncoding, BggPublicKey))


def _is_vec(w) -> bool:
    return isinstance(w, (BGGEncodingVec, BGGPublicKeyVec))


def _vec_slots(w) -> tuple:
    return w.keys if isinstance(w, BGGPublicKeyVec) else w.encodings


def _vec_ctor(w):
    return BGGPublicKeyVec.new if isinstance(w, BGGPublicKeyVec) else BGGEncodingVec.new


class WireStore:
    """Wire map with a device-resident byte budget: when live wires exceed
    `budget_bytes`, the least-recently-touched BGG wires spill to host compact
    bytes and rehydrate, on the device they came from, on next access.
    `peak_live_bytes` records the high-water mark for tests and benchmarks."""

    def __init__(self, params, budget_bytes: int = 0):
        self.params = params
        self.budget = budget_bytes
        self.live: dict = {}
        self.spilled: dict = {}
        self.clock = 0
        self.last_touch: dict = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.spill_count = 0

    # -- byte accounting (int64 limb planes)

    @staticmethod
    def _wire_bytes(w) -> int:
        if isinstance(w, BggEncoding):
            return int(w.vector.data.nbytes) + int(w.pubkey.matrix.data.nbytes)
        if isinstance(w, BggPublicKey):
            return int(w.matrix.data.nbytes)
        if _is_vec(w):  # tracked, never spilled; a vec's slots share one shape
            slots = _vec_slots(w)
            return len(slots) * WireStore._wire_bytes(slots[0]) if slots else 0
        return 0  # foreign wire types are not tracked or spilled

    # -- compact-form spill/rehydrate

    @staticmethod
    def _to_compact(w):
        if isinstance(w, BggEncoding):
            pt = w.plaintext.to_compact_bytes() if w.plaintext is not None else None
            return (
                "enc",
                w.vector.data.device,
                w.vector.to_compact_bytes(),
                w.pubkey.matrix.to_compact_bytes(),
                w.pubkey.reveal_plaintext,
                pt,
            )
        return ("pk", w.matrix.data.device, w.matrix.to_compact_bytes(), w.reveal_plaintext)

    def _from_compact(self, rec):
        p = self.params
        if rec[0] == "enc":
            _, device, vec_b, pk_b, reveal, pt_b = rec
            pt = Poly.from_compact_bytes(p, pt_b, device) if pt_b is not None else None
            return BggEncoding(
                PolyMatrix.from_compact_bytes(p, vec_b, device),
                BggPublicKey(PolyMatrix.from_compact_bytes(p, pk_b, device), reveal),
                pt,
            )
        _, device, m_b, reveal = rec
        return BggPublicKey(PolyMatrix.from_compact_bytes(p, m_b, device), reveal)

    def _enforce(self):
        if not self.budget or self.live_bytes <= self.budget:
            return
        # spill least-recently-touched spillable wires until under budget
        order = sorted(
            (gid for gid in self.live if _is_bgg(self.live[gid])),
            key=lambda gid: self.last_touch.get(gid, 0),
        )
        for gid in order:
            if self.live_bytes <= self.budget:
                break
            w = self.live.pop(gid)
            self.live_bytes -= self._wire_bytes(w)
            self.spilled[gid] = self._to_compact(w)
            self.spill_count += 1

    # -- mapping surface used by the evaluator

    def __setitem__(self, gid, w):
        self.pop(gid, None)
        self.live[gid] = w
        self.clock += 1
        self.last_touch[gid] = self.clock
        self.live_bytes += self._wire_bytes(w)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        self._enforce()

    def __getitem__(self, gid):
        if gid in self.live:
            self.clock += 1
            self.last_touch[gid] = self.clock
            return self.live[gid]
        w = self._from_compact(self.spilled.pop(gid))
        self[gid] = w
        return w

    def __contains__(self, gid):
        return gid in self.live or gid in self.spilled

    def pop(self, gid, default=None):
        if gid in self.live:
            w = self.live.pop(gid)
            self.live_bytes -= self._wire_bytes(w)
            self.last_touch.pop(gid, None)
            return w
        return self.spilled.pop(gid, default)


def _parts(gates, wire, least: int):
    """`gates` cut into runs whose wires (each the size of `wire`) fit
    `config.lut_bytes_limit()`; no run is shorter than `least` unless it is
    the last."""
    step = max(least, config.lut_bytes_limit() // max(1, WireStore._wire_bytes(wire)))
    return [gates[i : i + step] for i in range(0, len(gates), step)]


def _wire_sig(circuit, wires, g):
    """Group signature: gates with equal signatures batch together."""
    ins = [wires[i] for i in g.inputs]
    if not all(_is_bgg(w) for w in ins):
        return None
    kinds = tuple(type(w).__name__ for w in ins)
    shapes = []
    for w in ins:
        m = w.vector if isinstance(w, BggEncoding) else w.matrix
        shapes.append(m.shape)
        if isinstance(w, BggEncoding):
            shapes.append(w.pubkey.matrix.shape)
    if g.kind == MUL:
        left, right = ins[0], ins[1]
        if type(left) is not type(right):
            return None
        if isinstance(left, BggEncoding) and left.plaintext is None:
            return None
    return (g.kind, kinds, tuple(shapes))


def _vec_sig(circuit, wires, g):
    """Group signature of a gate over vec wires of one slot count: the
    scalar signature of its slot-0 stand-in, tagged with the slot count."""
    ins = [wires[i] for i in g.inputs]
    if not ins or not all(_is_vec(w) for w in ins):
        return None
    ns = len(_vec_slots(ins[0]))
    if any(len(_vec_slots(w)) != ns for w in ins):
        return None
    if g.kind == MUL and isinstance(ins[0], BGGEncodingVec) and any(
        e.plaintext is None for e in ins[0].encodings
    ):
        return None
    sig = _wire_sig(circuit, {i: _vec_slots(wires[i])[0] for i in g.inputs}, g)
    return None if sig is None else ("vec", ns) + sig


def _flatten_vec(gates, wires):
    """One scalar stand-in gate per (gate, slot), its inputs keyed
    (input id, slot) in a map of the slots' wires."""
    slot_wires = {}
    pseudo = []
    for g in gates:
        ns = len(_vec_slots(wires[g.inputs[0]]))
        for s in range(ns):
            keys = []
            for i in g.inputs:
                slot_wires[(i, s)] = _vec_slots(wires[i])[s]
                keys.append((i, s))
            pseudo.append(Gate(g.gate_id, g.kind, tuple(keys), g.payload))
    return pseudo, slot_wires


def _eval_form(w, memo: dict):
    """The wire with its matrices in EVAL form, each distinct wire converted
    once (a vec that repeats one wire in every slot would otherwise be
    transformed again by every gate that stacks it); equal in value, so
    results are the same bits."""
    if id(w) in memo:
        return memo[id(w)]
    if isinstance(w, BggPublicKey):
        out = w if w.matrix.fmt == EVAL else BggPublicKey(w.matrix.to_eval(), w.reveal_plaintext)
    elif isinstance(w, BggEncoding):
        out = w
        if w.vector.fmt != EVAL or w.pubkey.matrix.fmt != EVAL:
            out = BggEncoding(w.vector.to_eval(), _eval_form(w.pubkey, memo), w.plaintext)
    elif _is_vec(w):
        slots = _vec_slots(w)
        conv = [_eval_form(x, memo) for x in slots]
        out = w if all(a is b for a, b in zip(conv, slots)) else _vec_ctor(w)(conv)
    else:
        out = w
    memo[id(w)] = out
    return out


class Rows(NamedTuple):
    """The operands, or the results, of B gates as stacked EVAL tensors:
    public keys pk [L, B, d, m, n]; over encodings also the vectors vec
    [L, B, r, m, n] and the plaintexts pt [L, B, n]. A row whose plaintext
    is not known holds some value, and the caller keeps which are known."""

    pk: torch.Tensor
    vec: torch.Tensor | None = None
    pt: torch.Tensor | None = None


def rows_of(params, ws) -> tuple[Rows, np.ndarray, np.ndarray]:
    """The rows of equal-shape scalar BGG+ wires, their reveal flags and
    which of their plaintexts are known."""
    if isinstance(ws[0], BggPublicKey):
        return (Rows(stack_rows(params, [w.matrix for w in ws])),
                np.array([w.reveal_plaintext for w in ws]), np.zeros(len(ws), dtype=bool))
    pk = stack_rows(params, [w.pubkey.matrix for w in ws])
    known = np.array([w.plaintext is not None for w in ws])
    if known.all():
        pt = stack_rows(params, [w.plaintext for w in ws])
    else:
        pt = torch.zeros((params.crt_depth, len(ws), params.n), dtype=torch.int64,
                         device=pk.device)
        if known.any():
            idx = np.nonzero(known)[0]
            pt[:, torch.from_numpy(idx).to(pk.device)] = stack_rows(
                params, [ws[i].plaintext for i in idx])
    return (Rows(pk, stack_rows(params, [w.vector for w in ws]), pt),
            np.array([w.pubkey.reveal_plaintext for w in ws]), known)


def wires_of(params, out: Rows, reveal, known) -> list:
    """The wires of B result rows (views)."""
    pks = [PolyMatrix(out.pk[:, i], EVAL, params) for i in range(out.pk.shape[1])]
    if out.vec is None:
        return [BggPublicKey(m, bool(r)) for m, r in zip(pks, reveal)]
    return [
        BggEncoding(PolyMatrix(out.vec[:, i], EVAL, params), BggPublicKey(m, bool(reveal[i])),
                    Poly(out.pt[:, i], EVAL, params) if known[i] else None)
        for i, m in enumerate(pks)
    ]


def scalar_rows(params, scalars, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, U, n] EVAL data of the distinct gate scalars (coefficient lists)
    and each gate's index into it: the slots of a vec gate, or a constant
    used twice, share one."""
    made: dict = {}
    inv = [made.setdefault(tuple(s), len(made)) for s in scalars]
    data = stack_rows(params, [scalar_poly(params, list(s), device) for s in made])
    return data, torch.tensor(inv, dtype=torch.int64, device=device)


def _matmul(left: torch.Tensor, dec: torch.Tensor, q) -> torch.Tensor:
    """left[:, b] @ dec[b]: [L, B, r, k, n] and [B, L, k, c, n] to [L, B, r, c, n]."""
    return zq_matmul(left.transpose(0, 1), dec, q).transpose(0, 1)


def gate_rows(params, kind, a: Rows, b: Rows | None = None, scalars=None) -> Rows:
    """B gates of one batchable kind over their operand rows: `b` for Add,
    Sub and Mul, `scalars` (from `scalar_rows`) for SmallScalarMul and
    LargeScalarMul. Mul reads the left operands' plaintexts, which must be
    known."""
    q = params.tables(a.pk.device).moduli
    enc = a.vec is not None
    if kind in (ADD, SUB):
        ew = ew_add if kind == ADD else ew_sub
        if not enc:
            return Rows(ew(a.pk, b.pk, q))
        return Rows(ew(a.pk, b.pk, q), ew(a.vec, b.vec, q), ew(a.pt, b.pt, q))
    if kind == MUL:
        # out = a @ G^{-1}(A_b), and over encodings + x_a * b.vector
        dec = decompose_rows(params, b.pk)  # [B, L, m, c, n]
        pk = _matmul(a.pk, dec, q)
        if not enc:
            return Rows(pk)
        second = ew_mul(b.vec, a.pt[:, :, None, None, :], q)
        return Rows(pk, ew_add(_matmul(a.vec, dec, q), second, q), ew_mul(a.pt, b.pt, q))
    s_data, inv = scalars
    s = s_data.index_select(1, inv)  # [L, B, n]
    if kind == SMALL_SCALAR_MUL:
        # elementwise by the gate's scalar poly
        out = [ew_mul(x, s[:, :, None, None, :], q) for x in (a.pk, a.vec) if x is not None]
    else:
        # LargeScalarMul: w @ G^{-1}(c G), each distinct c decomposed once
        g_data = PolyMatrix.gadget_matrix(params, a.pk.shape[2], a.pk.device).data
        sg = ew_mul(g_data[:, None], s_data[:, :, None, None, :], q)  # [L, U, d, m, n]
        dec = decompose_rows(params, sg).index_select(0, inv)  # [B, L, d*k, m, n]
        out = [_matmul(x, dec, q) for x in (a.pk, a.vec) if x is not None]
    if enc:
        out.append(ew_mul(a.pt, s, q))
    return Rows(*out)


def _exec(params, kind, gates, wires, resolve) -> list:
    """A batch of gates of one kind over the wire map, through `gate_rows`."""
    a, reveal, known = rows_of(params, [wires[g.inputs[0]] for g in gates])
    b = scalars = None
    if kind in (ADD, SUB, MUL):
        b, reveal_b, known_b = rows_of(params, [wires[g.inputs[1]] for g in gates])
        reveal, known = reveal & reveal_b, known & known_b
    else:
        scalars = scalar_rows(params, [resolve(g) for g in gates], a.pk.device)
    return wires_of(params, gate_rows(params, kind, a, b, scalars), reveal, known)


def eval_batched(circuit, params, one, inputs, plt_evaluator=None,
                 slot_transfer_evaluator=None, param_bindings: tuple = (),
                 live_bytes_budget: int | None = None, wire_store_out: list | None = None):
    """Drop-in for PolyCircuit.eval with level-grouped batched device ops.
    Results are bit-identical to the sequential evaluator. With a
    `live_bytes_budget` (or MXX_CIRCUIT_LIVE_BYTES_BUDGET), idle wires beyond
    the budget spill to host compact bytes (pass `wire_store_out=[]` to
    receive the WireStore for peak/spill introspection)."""
    assert len(inputs) == circuit.num_input
    budget = (
        live_bytes_budget
        if live_bytes_budget is not None
        else config.circuit_live_bytes_budget()
    )
    if not budget and wire_store_out is None:
        # a uniform BGG+ circuit over one arena of wires (arena_eval.py)
        from .arena_eval import eval_arena

        out = eval_arena(circuit, params, one, inputs, plt_evaluator, param_bindings)
        if out is not None:
            return out
    uses = circuit.use_counts()
    wires = WireStore(params, budget)
    if wire_store_out is not None:
        wire_store_out.append(wires)
    # vec wires go to EVAL form once here (their slots repeat the one and -k
    # wires, which every gate that stacks them would transform again); a
    # scalar wire keeps its form
    memo: dict = {}
    for i, v in enumerate([one] + list(inputs)):
        wires[i] = _eval_form(v, memo) if _is_vec(v) else v
    del memo
    one = wires[0]
    remaining = list(uses)
    out_set = set(circuit.output_ids)
    call_cache: dict = {}
    summed_cache: dict = {}

    def consume(gate):
        for i in gate.inputs:
            remaining[i] -= 1
            if remaining[i] == 0 and i not in out_set:
                wires.pop(i, None)

    def eval_sub(circuit_id, sub_inputs, bindings):
        sub = circuit.sub_circuits[circuit_id]
        return eval_batched(
            sub, params, one, sub_inputs, plt_evaluator,
            slot_transfer_evaluator, param_bindings=bindings,
            live_bytes_budget=budget,
        )

    def eval_one(g):
        """Sequential fallback, mirroring PolyCircuit.eval's dispatch."""
        wires[g.gate_id] = circuit._gate_dispatch(
            g, wires, params, one, plt_evaluator, slot_transfer_evaluator,
            param_bindings, call_cache, summed_cache, eval_sub,
        )

    def resolve(g):
        return circuit._resolve_payload(g.payload, param_bindings)

    plt_batch = getattr(plt_evaluator, "public_lookup_batch", None)

    def exec_group(kind, gates, wire_map):
        return _exec(params, kind, gates, wire_map, resolve)

    for level in circuit.compute_levels():
        # group batchable gates by signature
        groups: dict = {}
        lut_gates = []
        singles = []
        for gid in level:
            g = circuit.gates[gid]
            if g.kind in _BATCHABLE:
                sig = _wire_sig(circuit, wires, g) or _vec_sig(circuit, wires, g)
                if sig is not None:
                    groups.setdefault(sig, []).append(g)
                    continue
            elif g.kind == PUB_LUT and plt_batch is not None and (
                _is_bgg(wires[g.inputs[0]]) or _is_vec(wires[g.inputs[0]])
            ):
                lut_gates.append(g)
                continue
            singles.append(g)
        if len(lut_gates) >= 2 or any(_is_vec(wires[g.inputs[0]]) for g in lut_gates):
            # group by input wire type/shape: the batch evaluators stack operands
            lut_groups: dict = {}
            for g in lut_gates:
                w = wires[g.inputs[0]]
                ns = len(_vec_slots(w)) if _is_vec(w) else 0
                x = _vec_slots(w)[0] if ns else w
                m = x.vector if hasattr(x, "vector") else x.matrix
                lut_groups.setdefault((type(w).__name__, ns, m.shape), []).append(g)
            for (_, ns, _), group in lut_groups.items():
                least = 1 if ns else 2
                for part in _parts(group, wires[group[0].inputs[0]], least):
                    if len(part) < least:
                        singles.extend(part)
                        continue
                    items = [
                        (circuit.luts[g.payload], wires[g.inputs[0]], g.gate_id, g.payload)
                        for g in part
                    ]
                    for g, out in zip(part, plt_batch(params, items)):
                        wires[g.gate_id] = out
                        consume(g)
        else:
            singles.extend(lut_gates)
        for sig, group in groups.items():
            if sig[0] == "vec":
                # every (gate, slot) of the group in scalar batches, then
                # each gate's vec regrouped from its slots
                pseudo, slot_wires = _flatten_vec(group, wires)
                slot_outs = []
                for part in _parts(pseudo, slot_wires[pseudo[0].inputs[0]], 1):
                    slot_outs.extend(exec_group(sig[2], part, slot_wires))
                del slot_wires
                ns = sig[1]
                for j, g in enumerate(group):
                    ctor = _vec_ctor(wires[g.inputs[0]])
                    wires[g.gate_id] = ctor(slot_outs[j * ns : (j + 1) * ns])
                    consume(g)
                continue
            for gates in _parts(group, wires[group[0].inputs[0]], MIN_BATCH):
                if len(gates) < MIN_BATCH:
                    singles.extend(gates)
                    continue
                for g, out in zip(gates, exec_group(sig[0], gates, wires)):
                    wires[g.gate_id] = out
                    consume(g)
        # deterministic order for the sequential remainder
        for g in sorted(singles, key=lambda g: g.gate_id):
            if g.kind == INPUT:
                continue
            eval_one(g)
            consume(g)

    return [wires[o] for o in circuit.output_ids]
