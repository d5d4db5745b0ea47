"""Level-batched evaluation of a uniform BGG+ circuit over one wire arena.

`eval_batched` hands a circuit here when every wire is a scalar
`BggPublicKey`, or every wire a scalar `BggEncoding`, all of one shape, and
every gate is Add, Sub, Mul, SmallScalarMul, LargeScalarMul or PubLut. Such
circuits (the Goldreich PRG rounds over Ring-GSW ciphertexts, the
refresh-material and decrypt circuits of real-mode Diamond iO) hold millions
of gates of a few bytes each at a toy ring, so the per-gate host work of the
general evaluator, not the device, sets their time. Here no wire object
exists between the inputs and the outputs:

- each gate's result is one row of an arena tensor indexed by gate id
  (public keys [L, G, d, m, n], encoding vectors [L, G, r, m, n],
  plaintexts [L, G, n], all EVAL), with numpy flags for the plaintexts that
  are known and the public keys that reveal them;
- a level's gates of one kind gather their operands with one index per
  operand, run `batched_eval.gate_rows` (the general walk's code for each
  kind) and scatter their results with one index copy;
- the level structure is computed once per circuit and kept on it.

Results equal the general evaluator's (both run `gate_rows`), and the
outputs are fresh EVAL matrices. The arena is used when each of its
tensors fits `config.lut_bytes_limit()` (no wire is freed before the end);
otherwise, and for any other circuit, `eval_batched` walks the circuit
itself.

PubLut gates go to the evaluator's `public_lookup_rows` when it has one (the
debug evaluators: one call per level over the stacked rows), else through
`public_lookup_batch` / `public_lookup` over wire objects, in the parts and
order in which `eval_batched` makes its calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..bgg import BggEncoding, BggPublicKey
from .batched_eval import Rows, _parts, gate_rows, rows_of, scalar_rows, wires_of
from .gate import ADD, INPUT, LARGE_SCALAR_MUL, MUL, PUB_LUT, SMALL_SCALAR_MUL, SUB

_KINDS = (INPUT, ADD, SUB, MUL, SMALL_SCALAR_MUL, LARGE_SCALAR_MUL, PUB_LUT)
_CODES = {kind: code for code, kind in enumerate(_KINDS)}
_ARITY = (0, 2, 2, 2, 1, 1, 1)


class _Plan:
    """A circuit's gates as arrays: kind codes, operand ids, and the
    (level, kind) groups in level order."""

    def __init__(self, circuit):
        gates = circuit.gates
        G = len(gates)
        kind = np.zeros(G, dtype=np.int8)
        in0 = np.zeros(G, dtype=np.int64)
        in1 = np.zeros(G, dtype=np.int64)
        depth = [0] * G
        self.ok = True
        for g in gates:
            code = _CODES.get(g.kind)
            ins = g.inputs
            if code is None or len(ins) != _ARITY[code]:
                self.ok = False
                return
            if ins:
                gid = g.gate_id
                kind[gid] = code
                a = ins[0]
                in0[gid] = a
                d = depth[a]
                if len(ins) == 2:
                    b = ins[1]
                    in1[gid] = b
                    if depth[b] > d:
                        d = depth[b]
                depth[gid] = d + 1
        self.kind, self.in0, self.in1 = kind, in0, in1
        dep = np.asarray(depth, dtype=np.int64)
        ids = np.nonzero(kind)[0]
        order = np.lexsort((ids, kind[ids], dep[ids]))
        ids = ids[order]
        key = dep[ids] * 8 + kind[ids]
        cuts = np.nonzero(np.diff(key))[0] + 1
        self.groups = [(_KINDS[kind[part[0]]], int(dep[part[0]]), part)
                       for part in np.split(ids, cuts) if len(part)]
        used = np.zeros(G, dtype=bool)
        used[in0[ids]] = True
        two = (kind[ids] >= 1) & (kind[ids] <= 3)  # Add, Sub, Mul
        used[in1[ids[two]]] = True
        used[np.asarray(circuit.output_ids, dtype=np.int64)] = True
        self.used = used


def plan(circuit) -> _Plan:
    """The circuit's plan, kept on the circuit while it does not grow."""
    key = (len(circuit.gates), len(circuit.output_ids))
    cached = circuit.__dict__.get("_arena_plan")
    if cached is None or cached[0] != key:
        cached = (key, _Plan(circuit))
        circuit.__dict__["_arena_plan"] = cached
    return cached[1]


def _index(ids: np.ndarray, device) -> torch.Tensor | slice:
    """A slice when the ids are one contiguous run, else an index tensor."""
    if len(ids) and ids[-1] - ids[0] + 1 == len(ids) and (np.diff(ids) == 1).all():
        return slice(int(ids[0]), int(ids[-1]) + 1)
    return torch.from_numpy(ids).to(device)


def _take(t: torch.Tensor, ix) -> torch.Tensor:
    return t[:, ix] if isinstance(ix, slice) else t.index_select(1, ix)


def _put(t: torch.Tensor, ix, value: torch.Tensor) -> None:
    if isinstance(ix, slice):
        t[:, ix] = value
    else:
        t.index_copy_(1, ix, value)


class _Arena:
    """Every gate's result as one row of the stacked tensors, indexed by gate
    id, with its reveal flag and whether its plaintext is known."""

    def __init__(self, params, G, pk_shape, vec_shape, device):
        L, n = params.crt_depth, params.n
        self.params, self.device = params, device
        self.enc = vec_shape is not None
        self.pk = torch.empty((L, G) + pk_shape + (n,), dtype=torch.int64, device=device)
        self.reveal = np.zeros(G, dtype=bool)
        self.pt_ok = np.zeros(G, dtype=bool)
        if self.enc:
            self.vec = torch.empty((L, G) + vec_shape + (n,), dtype=torch.int64, device=device)
            self.pt = torch.zeros((L, G, n), dtype=torch.int64, device=device)

    def take(self, ids: np.ndarray, fresh: bool = False) -> Rows:
        """The gates' rows: views where the ids run contiguously, unless
        `fresh` asks for copies."""
        ix = torch.from_numpy(ids).to(self.device) if fresh else _index(ids, self.device)
        if not self.enc:
            return Rows(_take(self.pk, ix))
        return Rows(_take(self.pk, ix), _take(self.vec, ix), _take(self.pt, ix))

    def put(self, ids: np.ndarray, out: Rows, reveal, known) -> None:
        ix = _index(ids, self.device)
        _put(self.pk, ix, out.pk)
        self.reveal[ids] = reveal
        if self.enc:
            _put(self.vec, ix, out.vec)
            _put(self.pt, ix, out.pt)
            self.pt_ok[ids] = known

    def wires(self, ids: np.ndarray, fresh: bool = False) -> list:
        """The gates' results as wire objects."""
        return wires_of(self.params, self.take(ids, fresh), self.reveal[ids], self.pt_ok[ids])


def eval_arena(circuit, params, one, inputs, plt_evaluator=None, param_bindings: tuple = ()):
    """The circuit's outputs, or None when the arena does not apply."""
    wires_in = [one] + list(inputs)
    enc = isinstance(one, BggEncoding)
    cls = BggEncoding if enc else BggPublicKey
    if not isinstance(one, (BggEncoding, BggPublicKey)):
        return None
    pk0 = one.pubkey.matrix if enc else one.matrix
    vec0 = one.vector if enc else None
    for w in wires_in:
        if w is None:
            continue
        if type(w) is not cls:
            return None
        if (w.pubkey.matrix if enc else w.matrix).shape != pk0.shape:
            return None
        if enc and w.vector.shape != vec0.shape:
            return None
    G = len(circuit.gates)
    L, n = params.crt_depth, params.n
    row_bytes = L * pk0.nrow * pk0.ncol * n * 8
    if enc:
        row_bytes = max(row_bytes, L * vec0.nrow * vec0.ncol * n * 8)
    if G * row_bytes > config.lut_bytes_limit():
        return None
    pl = plan(circuit)
    if not pl.ok:
        return None
    if any(w is None and pl.used[i] for i, w in enumerate(wires_in)):
        return None
    has_lut = any(kind == PUB_LUT for kind, _, _ in pl.groups)
    rows_api = getattr(plt_evaluator, "public_lookup_rows", None)
    batch_api = getattr(plt_evaluator, "public_lookup_batch", None)
    if has_lut and plt_evaluator is None:
        return None

    device = pk0.data.device
    ar = _Arena(params, G, tuple(pk0.shape), tuple(vec0.shape) if enc else None, device)
    present = np.array([i for i, w in enumerate(wires_in) if w is not None])
    ar.put(present, *rows_of(params, [wires_in[i] for i in present]))
    gates = circuit.gates

    def lut_level(ids):
        a = pl.in0[ids]
        lut_ids = [gates[i].payload for i in ids]
        if rows_api is not None:
            if enc and not ar.pt_ok[a].all():
                raise ValueError("LUT input must reveal its plaintext")
            ins = ar.take(a)
            out = rows_api(params, [circuit.luts[x] for x in lut_ids], ids.tolist(), lut_ids,
                           ins.pk, ins.pt)
            ar.put(ids, Rows(*out), True, True)
            return
        # wire objects, in the parts and order of eval_batched's calls
        singles = ids
        if batch_api is not None and len(ids) >= 2:
            ins = ar.wires(a)
            singles = []
            for part in _parts(list(range(len(ids))), ins[0], 2):
                if len(part) < 2:
                    singles.extend(ids[part])
                    continue
                outs = batch_api(params, [(circuit.luts[lut_ids[j]], ins[j], int(ids[j]),
                                           lut_ids[j]) for j in part])
                ar.put(ids[part], *rows_of(params, outs))
        for i in singles:
            out = plt_evaluator.public_lookup(params, circuit.luts[gates[i].payload], one,
                                              ar.wires(pl.in0[[i]])[0], int(i), gates[i].payload)
            ar.put(np.array([i]), *rows_of(params, [out]))

    for kind, _, ids in pl.groups:
        if kind == PUB_LUT:
            lut_level(ids)
            continue
        a = pl.in0[ids]
        reveal, known = ar.reveal[a], ar.pt_ok[a]
        b = scalars = None
        if kind in (ADD, SUB, MUL):
            if kind == MUL and enc and not known.all():
                raise ValueError("unknown plaintext for the left-hand input of multiplication")
            b = ar.take(pl.in1[ids])
            reveal, known = reveal & ar.reveal[pl.in1[ids]], known & ar.pt_ok[pl.in1[ids]]
        else:
            scalars = scalar_rows(params, [circuit._resolve_payload(gates[i].payload,
                                                                    param_bindings)
                                           for i in ids], device)
        ar.put(ids, gate_rows(params, kind, ar.take(a), b, scalars), reveal, known)

    # copies: no output keeps the arena alive
    return ar.wires(np.asarray(circuit.output_ids, dtype=np.int64), fresh=True)
