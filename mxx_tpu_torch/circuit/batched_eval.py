"""Level-batched circuit evaluation over BGG wires.

The port's counterpart of `mxx_tpu/circuit/batched_eval.py`. Gates are walked
level by level; same-kind same-shape gates within a level collapse into one
batched op over a row-stacked operand tensor: stacking B one-row wires gives
[L, B*r, c, n] operands (or [B, L, r, c, n] ones for the matmul) that the
exact ops (`ew_*`, `zq_matmul`, `digit_decompose`, `ntt_*_auto`) take
unchanged, so batched results are bit-identical to sequential ones.

Batched kinds: Add/Sub/Mul/SmallScalarMul/LargeScalarMul over
BggEncoding/BggPublicKey wires. Everything else (PubLut, slot gates,
sub-circuit calls, foreign wire types) goes through the sequential per-gate
dispatch inside the same level walk, so `eval_batched` accepts any circuit
`eval` accepts.

Results stay on the device: each gate's output is a view of its batch's
result tensor. The batched decomposition transforms through `ntt_inv_auto` /
`ntt_fwd_auto`, so on a card it runs the four-step kernels.
"""

from __future__ import annotations

import torch

from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..ops.decompose import digit_decompose
from ..ops.elementwise import ew_add, ew_mul, ew_sub
from ..ops.zq_matmul import zq_matmul
from ..ring.ntt import ntt_fwd_auto, ntt_inv_auto
from ..ring.poly import EVAL, Poly, scalar_poly
from .gate import ADD, INPUT, LARGE_SCALAR_MUL, MUL, PUB_LUT, SMALL_SCALAR_MUL, SUB

MIN_BATCH = 3

_BATCHABLE = {ADD, SUB, MUL, SMALL_SCALAR_MUL, LARGE_SCALAR_MUL}


def _is_bgg(w) -> bool:
    return isinstance(w, (BggEncoding, BggPublicKey))


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


def _pk(w) -> PolyMatrix:
    return w.pubkey.matrix if isinstance(w, BggEncoding) else w.matrix


def _stack(mats) -> torch.Tensor:
    """EVAL datas of equal-shape matrices, row-concatenated: [L, B*r, c, n]."""
    return torch.cat([m.to_eval().data for m in mats], dim=1)


def _unstack(params, data, count, rows) -> list[PolyMatrix]:
    """Per-gate matrices: row views of a batched [L, B*rows, c, n] result."""
    return [PolyMatrix(data[:, i * rows : (i + 1) * rows], EVAL, params) for i in range(count)]


def _stack_polys(polys) -> torch.Tensor:
    return torch.stack([p.to_eval().data for p in polys], dim=1)  # [L, B, n]


def _stack_b(mats) -> torch.Tensor:
    """[B, L, r, c, n] view of the EVAL datas of equal-shape matrices."""
    data = _stack(mats)
    L, _, c, n = data.shape
    return data.reshape(L, len(mats), mats[0].nrow, c, n).transpose(0, 1)


def _batched_plaintexts(kind, params, pas, pbs):
    """Batched plaintext +/-/* for B gates as one op. Gates with a missing
    operand plaintext get None, as in the per-gate path."""
    present = [i for i in range(len(pas)) if pas[i] is not None and pbs[i] is not None]
    out_list = [None] * len(pas)
    if not present:
        return out_list
    q = params.tables(pas[present[0]].data.device).moduli
    a = _stack_polys([pas[i] for i in present])  # [L, P, n]
    b = _stack_polys([pbs[i] for i in present])
    if kind == ADD:
        out = ew_add(a, b, q)
    elif kind == SUB:
        out = ew_sub(a, b, q)
    else:
        out = ew_mul(a, b, q)
    for j, i in enumerate(present):
        out_list[i] = Poly(out[:, j], EVAL, params)
    return out_list


def _exec_add_sub(params, gates, wires):
    ins_a = [wires[g.inputs[0]] for g in gates]
    ins_b = [wires[g.inputs[1]] for g in gates]
    kind = gates[0].kind
    ew = ew_add if kind == ADD else ew_sub
    enc = isinstance(ins_a[0], BggEncoding)
    q = params.tables(_pk(ins_a[0]).data.device).moduli
    B = len(gates)
    prow = _pk(ins_a[0]).nrow
    pks = _unstack(params, ew(_stack([_pk(w) for w in ins_a]), _stack([_pk(w) for w in ins_b]), q),
                   B, prow)
    if not enc:
        return [BggPublicKey(pks[i], a.reveal_plaintext and b.reveal_plaintext)
                for i, (a, b) in enumerate(zip(ins_a, ins_b))]
    rows = ins_a[0].vector.nrow
    vec = ew(_stack([w.vector for w in ins_a]), _stack([w.vector for w in ins_b]), q)
    vecs = _unstack(params, vec, B, rows)
    pts = _batched_plaintexts(kind, params, [w.plaintext for w in ins_a],
                              [w.plaintext for w in ins_b])
    outs = []
    for i, (a, b) in enumerate(zip(ins_a, ins_b)):
        reveal = a.pubkey.reveal_plaintext and b.pubkey.reveal_plaintext
        outs.append(BggEncoding(vecs[i], BggPublicKey(pks[i], reveal), pts[i]))
    return outs


def _scalar_polys(params, gates, resolve, device) -> list[Poly]:
    return [scalar_poly(params, list(resolve(g)), device) for g in gates]


def _exec_scalar_mul(params, gates, wires, resolve):
    """SmallScalarMul batched: elementwise multiply by per-gate scalar polys."""
    ins = [wires[g.inputs[0]] for g in gates]
    device = _pk(ins[0]).data.device
    scalars = _scalar_polys(params, gates, resolve, device)
    s_data = _stack_polys(scalars)  # [L, B, n]
    q = params.tables(device).moduli
    enc = isinstance(ins[0], BggEncoding)
    B = len(gates)

    def mul_stacked(mats):
        rows = mats[0].nrow
        s = s_data.repeat_interleave(rows, dim=1)[:, :, None, :]  # [L, B*rows, 1, n]
        return _unstack(params, ew_mul(_stack(mats), s, q), B, rows)

    pks = mul_stacked([_pk(w) for w in ins])
    if not enc:
        return [BggPublicKey(pks[i], w.reveal_plaintext) for i, w in enumerate(ins)]
    vecs = mul_stacked([w.vector for w in ins])
    pts = _batched_plaintexts(MUL, params, [w.plaintext for w in ins], scalars)
    return [BggEncoding(vecs[i], BggPublicKey(pks[i], w.pubkey.reveal_plaintext), pts[i])
            for i, w in enumerate(ins)]


def _batched_decompose(params, mats) -> torch.Tensor:
    """G^{-1} of B equal-shape matrices, transformed to EVAL form, as one
    batch: [B, L, r*k, c, n], ready for the exact matmul."""
    p = params
    if all(m.fmt == EVAL for m in mats):
        data = ntt_inv_auto(_stack(mats), p)  # one batched inverse transform
    else:
        data = torch.cat([m.to_coeff().data for m in mats], dim=1)  # [L, B*r, c, n]
    t = p.tables(data.device)
    dec = digit_decompose(
        data, t.moduli, t.digit_masks,
        base_bits=p.base_bits, dpt=p.digits_per_tower, towers=p.crt_depth,
    )  # [L, B*r*k, c, n] COEFF
    dec = ntt_fwd_auto(dec, p)
    L, _, c, n = dec.shape
    return dec.reshape(L, len(mats), mats[0].nrow * p.modulus_digits, c, n).transpose(0, 1)


def _exec_mul(params, gates, wires):
    """BGG mul batched: out = a.vector @ G^{-1}(A_b) + x_a * b.vector."""
    ins_a = [wires[g.inputs[0]] for g in gates]
    ins_b = [wires[g.inputs[1]] for g in gates]
    B = len(gates)
    dec = _batched_decompose(params, [_pk(w) for w in ins_b])  # [B, L, m, c, n]
    q = params.tables(dec.device).moduli
    out_pk = zq_matmul(_stack_b([_pk(w) for w in ins_a]), dec, q)  # [B, L, r, c, n]
    pks = [PolyMatrix(out_pk[i], EVAL, params) for i in range(B)]
    if not isinstance(ins_a[0], BggEncoding):
        return [BggPublicKey(pks[i], a.reveal_plaintext and b.reveal_plaintext)
                for i, (a, b) in enumerate(zip(ins_a, ins_b))]
    first = zq_matmul(_stack_b([w.vector for w in ins_a]), dec, q)  # [B, L, r, c, n]
    rows = ins_b[0].vector.nrow
    x_a = _stack_polys([w.plaintext for w in ins_a])  # [L, B, n]
    second = ew_mul(_stack([w.vector for w in ins_b]),
                    x_a.repeat_interleave(rows, dim=1)[:, :, None, :], q)  # [L, B*r, c, n]
    fB, fL, fr, fc, fn = first.shape
    vec = ew_add(first.transpose(0, 1).reshape(fL, fB * fr, fc, fn), second, q)
    vecs = _unstack(params, vec, B, rows)
    pts = _batched_plaintexts(MUL, params, [w.plaintext for w in ins_a],
                              [w.plaintext for w in ins_b])
    outs = []
    for i, (a, b) in enumerate(zip(ins_a, ins_b)):
        reveal = a.pubkey.reveal_plaintext and b.pubkey.reveal_plaintext
        outs.append(BggEncoding(vecs[i], BggPublicKey(pks[i], reveal), pts[i]))
    return outs


def _exec_large_scalar_mul(params, gates, wires, resolve):
    """LargeScalarMul batched: out = w @ G^{-1}(c * G) per gate scalar c."""
    ins = [wires[g.inputs[0]] for g in gates]
    device = _pk(ins[0]).data.device
    B = len(gates)
    scalars = _scalar_polys(params, gates, resolve, device)
    d = _pk(ins[0]).nrow
    g_data = PolyMatrix.gadget_matrix(params, d, device).data  # [L, d, m, n] EVAL
    q = params.tables(device).moduli
    sg = ew_mul(g_data.repeat(1, B, 1, 1),
                _stack_polys(scalars).repeat_interleave(d, dim=1)[:, :, None, :], q)
    dec = _batched_decompose(params, _unstack(params, sg, B, d))  # [B, L, d*k, m, n]
    out_pk = zq_matmul(_stack_b([_pk(w) for w in ins]), dec, q)
    pks = [PolyMatrix(out_pk[i], EVAL, params) for i in range(B)]
    if not isinstance(ins[0], BggEncoding):
        return [BggPublicKey(pks[i], w.reveal_plaintext) for i, w in enumerate(ins)]
    out_vec = zq_matmul(_stack_b([w.vector for w in ins]), dec, q)
    pts = _batched_plaintexts(MUL, params, [w.plaintext for w in ins], scalars)
    return [
        BggEncoding(PolyMatrix(out_vec[i], EVAL, params),
                    BggPublicKey(pks[i], w.pubkey.reveal_plaintext), pts[i])
        for i, w in enumerate(ins)
    ]


def eval_batched(circuit, params, one, inputs, plt_evaluator=None,
                 slot_transfer_evaluator=None, param_bindings: tuple = (),
                 live_bytes_budget: int | None = None, wire_store_out: list | None = None):
    """Drop-in for PolyCircuit.eval with level-grouped batched device ops.
    Results are bit-identical to the sequential evaluator. With a
    `live_bytes_budget` (or MXX_CIRCUIT_LIVE_BYTES_BUDGET), idle wires beyond
    the budget spill to host compact bytes (pass `wire_store_out=[]` to
    receive the WireStore for peak/spill introspection)."""
    from .. import config

    assert len(inputs) == circuit.num_input
    uses = circuit.use_counts()
    budget = (
        live_bytes_budget
        if live_bytes_budget is not None
        else config.circuit_live_bytes_budget()
    )
    wires = WireStore(params, budget)
    if wire_store_out is not None:
        wire_store_out.append(wires)
    wires[0] = one
    for i, v in enumerate(inputs):
        wires[i + 1] = v
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

    for level in circuit.compute_levels():
        # group batchable gates by signature
        groups: dict = {}
        lut_gates = []
        singles = []
        for gid in level:
            g = circuit.gates[gid]
            if g.kind in _BATCHABLE:
                sig = _wire_sig(circuit, wires, g)
                if sig is not None:
                    groups.setdefault(sig, []).append(g)
                    continue
            elif g.kind == PUB_LUT and plt_batch is not None and _is_bgg(wires[g.inputs[0]]):
                lut_gates.append(g)
                continue
            singles.append(g)
        if len(lut_gates) >= 2:
            # group by input wire type/shape: the batch evaluators stack operands
            lut_groups: dict = {}
            for g in lut_gates:
                w = wires[g.inputs[0]]
                m = w.vector if hasattr(w, "vector") else w.matrix
                lut_groups.setdefault((type(w).__name__, m.shape), []).append(g)
            for group in lut_groups.values():
                if len(group) < 2:
                    singles.extend(group)
                    continue
                items = [
                    (circuit.luts[g.payload], wires[g.inputs[0]], g.gate_id, g.payload)
                    for g in group
                ]
                for g, out in zip(group, plt_batch(params, items)):
                    wires[g.gate_id] = out
                    consume(g)
        else:
            singles.extend(lut_gates)
        for sig, gates in groups.items():
            if len(gates) < MIN_BATCH:
                singles.extend(gates)
                continue
            kind = sig[0]
            if kind in (ADD, SUB):
                outs = _exec_add_sub(params, gates, wires)
            elif kind == SMALL_SCALAR_MUL:
                outs = _exec_scalar_mul(params, gates, wires, resolve)
            elif kind == LARGE_SCALAR_MUL:
                outs = _exec_large_scalar_mul(params, gates, wires, resolve)
            else:
                outs = _exec_mul(params, gates, wires)
            for g, out in zip(gates, outs):
                wires[g.gate_id] = out
                consume(g)
        # deterministic order for the sequential remainder
        for g in sorted(singles, key=lambda g: g.gate_id):
            if g.kind == INPUT:
                continue
            eval_one(g)
            consume(g)

    return [wires[o] for o in circuit.output_ids]
