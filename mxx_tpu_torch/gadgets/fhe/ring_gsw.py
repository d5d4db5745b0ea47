"""RingGSW FHE evaluated inside circuits over nested-RNS entries.

A copy of `mxx_tpu/gadgets/fhe/ring_gsw.py`, after the reference's RingGSW gadget
(src/gadgets/fhe/{ring_gsw.rs,ring_gsw_nested_rns.rs};
SURVEY.md §2.4). A ciphertext is C = A + m*G in Z_Q^{2 x 2L} with
A = [a ; s*a + e], secret key (-s, 1), gadget G = I_2 (x) g where g is the
nested-RNS gadget row (L = active_levels * (k+1) weights from
`NestedRnsPoly.gadget_scalars`). The homomorphic external product is
C_out = C_lhs @ G^{-1}(C_rhs), realized in-circuit with nested-RNS
`gadget_decompose` + entry multiplications; Add/Sub are entrywise; boolean
AND = mul, XOR = a + b - 2ab over bit plaintexts (ring_gsw.rs:1297-1330).

Scope: scalar GSW ring (slot-packing degree 1). The packed small-ring
variant adds negacyclic conv over slots (conv_mul) on the same structure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ...circuit import PolyCircuit
from ...ring.poly import Poly
from ..arith.nested_rns import (
    NestedRnsPoly,
    NestedRnsPolyContext,
    decode_nested_rns_outputs,
    encode_nested_rns_value,
)


class RingGswContext:
    def __init__(self, circuit: PolyCircuit, params, p_moduli_bits: int,
                 max_unreduced_muls: int = 2, p_basis: str = "small",
                 scale: int | None = None):
        self.params = params
        self.nested = NestedRnsPolyContext(circuit, params, p_moduli_bits,
                                           max_unreduced_muls, scale=scale,
                                           p_basis=p_basis)
        self.q_big = math.prod(self.nested.q_moduli)

    def fresh_circuit(self) -> PolyCircuit:
        """New circuit sharing this context's LUT registry (reference
        ring_gsw.rs fresh_circuit)."""
        return self.nested.fresh_circuit()

    @property
    def gadget_len(self) -> int:
        return self.nested.q_moduli_depth * (self.nested.k + 1)

    @property
    def width(self) -> int:
        return 2 * self.gadget_len

    def gadget_row(self) -> list[int]:
        """g: the per-term gadget weights mod Q (length gadget_len)."""
        probe = NestedRnsPoly(
            self.nested,
            [[0] * self.nested.k for _ in range(self.nested.q_moduli_depth)],
            0,
            None,
            [0] * self.nested.q_moduli_depth,
            [0] * self.nested.q_moduli_depth,
        )
        return probe.gadget_scalars()


def _entry_reduced(e: NestedRnsPoly, circuit: PolyCircuit) -> NestedRnsPoly:
    """Full-reduce an entry unless it already satisfies the circuit-boundary
    bound (values <= full_reduce bound, traces < p_max)."""
    ctx = e.ctx
    ok = all(
        v <= ctx.full_reduce_max_plaintexts[e.level_offset + i]
        for i, v in enumerate(e.value_bounds)
    ) and all(t <= ctx.p_max - 1 for t in e.trace_bounds)
    return e if ok else e.full_reduce(circuit)


@dataclass
class RingGswCiphertext:
    ctx: RingGswContext
    rows: tuple[list[NestedRnsPoly], list[NestedRnsPoly]]
    max_plaintext: int = 1

    @staticmethod
    def input(ctx: RingGswContext, circuit: PolyCircuit,
              max_plaintext: int = 1, canonical: bool = True) -> "RingGswCiphertext":
        rows = tuple(
            [
                NestedRnsPoly.input(ctx.nested, circuit, canonical=canonical)
                for _ in range(ctx.width)
            ]
            for _ in range(2)
        )
        return RingGswCiphertext(ctx, rows, max_plaintext)

    @staticmethod
    def from_wires(ctx: RingGswContext, wires,
                   max_plaintext: int = 1, canonical: bool = True) -> "RingGswCiphertext":
        """Rebuild a ciphertext from gate ids in `flatten()` order (existing
        input/const/sub-circuit wires). `canonical=False` for round-output
        handoffs (see NestedRnsPoly.input)."""
        per_entry = ctx.nested.q_moduli_depth * ctx.nested.k
        ids = list(wires)
        assert len(ids) == 2 * ctx.width * per_entry, (len(ids), ctx.width, per_entry)
        rows: tuple[list, list] = ([], [])
        pos = 0
        for i in range(2):
            for _ in range(ctx.width):
                rows[i].append(
                    NestedRnsPoly.from_wires(
                        ctx.nested, ids[pos : pos + per_entry], canonical=canonical
                    )
                )
                pos += per_entry
        return RingGswCiphertext(ctx, rows, max_plaintext)

    @property
    def width(self) -> int:
        return len(self.rows[0])

    def flatten(self) -> list[int]:
        out = []
        for row in self.rows:
            for e in row:
                out.extend(e.flatten())
        return out

    def add(self, other: "RingGswCiphertext", circuit: PolyCircuit) -> "RingGswCiphertext":
        rows = tuple(
            [a.add(b, circuit) for a, b in zip(ra, rb)]
            for ra, rb in zip(self.rows, other.rows)
        )
        return RingGswCiphertext(self.ctx, rows, self.max_plaintext + other.max_plaintext)

    def sub(self, other: "RingGswCiphertext", circuit: PolyCircuit) -> "RingGswCiphertext":
        rows = tuple(
            [a.sub(b, circuit) for a, b in zip(ra, rb)]
            for ra, rb in zip(self.rows, other.rows)
        )
        return RingGswCiphertext(self.ctx, rows, self.max_plaintext + other.max_plaintext)

    def mul(self, other: "RingGswCiphertext", circuit: PolyCircuit) -> "RingGswCiphertext":
        """External product C_lhs @ G^{-1}(C_rhs) (ring_gsw.rs:1210-1297)."""
        L = self.ctx.gadget_len
        out_rows: tuple[list, list] = ([], [])
        for j in range(other.width):
            d0 = other.rows[0][j].gadget_decompose(circuit)
            d1 = other.rows[1][j].gadget_decompose(circuit)
            assert len(d0) == L and len(d1) == L
            for i in range(2):
                acc = None
                for t in range(L):
                    term = self.rows[i][t].mul(d0[t], circuit)
                    acc = term if acc is None else acc.add(term, circuit)
                for t in range(L):
                    term = self.rows[i][L + t].mul(d1[t], circuit)
                    acc = acc.add(term, circuit)
                out_rows[i].append(acc.full_reduce(circuit))
        return RingGswCiphertext(
            self.ctx, out_rows, self.max_plaintext * other.max_plaintext
        )

    def and_(self, other, circuit):
        assert self.max_plaintext == 1 and other.max_plaintext == 1
        return self.mul(other, circuit)

    def xor(self, other, circuit):
        assert self.max_plaintext == 1 and other.max_plaintext == 1
        s = self.add(other, circuit)
        p = self.mul(other, circuit)
        out = s.sub(p, circuit).sub(p, circuit)
        return RingGswCiphertext(out.ctx, out.rows, 1)

    def reduced(self, circuit: PolyCircuit) -> "RingGswCiphertext":
        """Full-reduce every entry beyond the boundary bound: the canonical
        circuit-boundary form. Round outputs handed to another circuit (next
        PRF round, the wrapped mask circuit) MUST cross reduced —
        input(canonical=False)/from_wires assume the full-reduced bound, and
        unreduced trace values overflow the consuming circuit's LUT domains
        (found by the first real-mode run). Entries already within the bound
        (e.g. fresh external-product outputs) pass through untouched."""
        rows = tuple(
            [_entry_reduced(e, circuit) for e in row] for row in self.rows
        )
        return RingGswCiphertext(self.ctx, rows, self.max_plaintext)

    def gadget_decompose_value_consts(self, value: int) -> list[int]:
        """Host-side gadget decomposition constants d_t of an integer:
        sum_t g_t * d_t == value (mod Q), ordered like gadget_row()."""
        ctx = self.ctx.nested
        out = []
        from ...utils.numth import modinv

        for q_l in ctx.q_moduli:
            r = value % q_l
            ys = []
            real_sum = 0
            for p in ctx.p_moduli:
                inv = modinv(ctx.p_full // p % p, p)
                y = (r % p) * inv % p
                ys.append(y)
                real_sum += ((y * ctx.scale) + p // 2) // p
            w = (real_sum + ctx.scale // 2) // ctx.scale
            out.extend(ys)
            out.append(w)
        return out

    def _decrypt_halves(self, circuit: PolyCircuit, plaintext_modulus: int
                        ) -> tuple[int, int]:
        """Pre-key decrypt halves (top, bottom) as single value wires:
        -s * top + bottom == (Q/t) m + noise."""
        ctx = self.ctx
        L = ctx.gadget_len
        scaled = ctx.q_big // plaintext_modulus
        d_consts = self.gadget_decompose_value_consts(scaled)
        assert len(d_consts) == L

        def combine(row_half):
            acc = None
            for t, c in enumerate(d_consts):
                term = row_half[t].const_mul(c, circuit)
                acc = term if acc is None else acc.add(term, circuit)
            return acc

        top = combine(self.rows[0][L:])
        bottom = combine(self.rows[1][L:])
        return top.reconstruct(circuit), bottom.reconstruct(circuit)

    def decrypt(self, circuit: PolyCircuit, key_wire: int, plaintext_modulus: int
                ) -> tuple[int, int]:
        """Split decryption (reference ring_gsw.rs:1506-1665): returns
        (secret_dependent, public_bottom) wires whose sum equals
        (Q / t) * m + noise. `key_wire` must carry -s (the key (-s, 1))."""
        top_wire, bottom_wire = self._decrypt_halves(circuit, plaintext_modulus)
        secret_dependent = circuit.mul_gate(top_wire, key_wire)
        return secret_dependent, bottom_wire

    @staticmethod
    def decrypt_batch(ciphertexts: list["RingGswCiphertext"], circuit: PolyCircuit,
                      key_wire: int, plaintext_modulus: int) -> tuple[int, int]:
        """Decrypt up to ring_dim coefficient ciphertexts into one polynomial
        wire pair: coefficient i rides monomial x^i, and the top halves are
        combined BEFORE the single key multiplication (reference
        ring_gsw.rs:1518+ decrypt_batch)."""
        assert ciphertexts, "decrypt_batch requires ciphertexts"
        params = ciphertexts[0].ctx.params
        assert len(ciphertexts) <= params.n
        top_acc = None
        bot_acc = None
        for i, ct in enumerate(ciphertexts):
            top, bottom = ct._decrypt_halves(circuit, plaintext_modulus)
            if i:
                mono = [0] * params.n
                mono[i] = 1
                top = circuit.small_scalar_mul(top, mono)
                bottom = circuit.small_scalar_mul(bottom, mono)
            top_acc = top if top_acc is None else circuit.add_gate(top_acc, top)
            bot_acc = bottom if bot_acc is None else circuit.add_gate(bot_acc, bottom)
        secret_dependent = circuit.mul_gate(top_acc, key_wire)
        return secret_dependent, bot_acc

    def reconstruct(self, circuit: PolyCircuit) -> list[int]:
        """Collapse each entry to a single value wire (2*width wires)."""
        out = []
        for row in self.rows:
            for e in row:
                out.append(e.reconstruct(circuit))
        return out


# ----------------------------------------------------------- native (host)


def sample_secret_key(rng) -> int:
    return rng.choice([-1, 0, 1])


def native_gadget_row(ctx: RingGswContext) -> list[int]:
    return ctx.gadget_row()


def native_encrypt(ctx: RingGswContext, s: int, m: int, rng, error_sigma: float = 0.0):
    """Host-side GSW encryption: 2 x 2L integer matrix mod Q
    (reference ring_gsw_nested_rns.rs:106-204). `rng` must be a CSPRNG
    (utils.rng.Drbg); errors come from the same rng."""
    q = ctx.q_big
    g = native_gadget_row(ctx)
    L = ctx.gadget_len
    a = [rng.randrange(q) for _ in range(2 * L)]
    if error_sigma > 0:
        e = [round(rng.gauss(0, error_sigma)) for _ in range(2 * L)]
    else:
        e = [0] * (2 * L)
    row0 = list(a)
    row1 = [(s * a[j] + e[j]) % q for j in range(2 * L)]
    for j in range(L):
        row0[j] = (row0[j] + m * g[j]) % q
    for j in range(L):
        row1[L + j] = (row1[L + j] + m * g[j]) % q
    return [row0, row1]


def native_decrypt_value(ctx: RingGswContext, native_ct, s: int, col: int) -> int:
    """(-s, 1) . C[:, col] mod Q = m * ((-s,1) G)[col] + e."""
    q = ctx.q_big
    return (-s * native_ct[0][col] + native_ct[1][col]) % q


def encode_ciphertext_inputs(ctx: RingGswContext, native_ct, device="cuda") -> list[Poly]:
    """Circuit input polys for `RingGswCiphertext.input`, entry-major."""
    out = []
    for row in native_ct:
        for v in row:
            for lvl in encode_nested_rns_value(ctx.nested, v % ctx.q_big):
                out.extend(Poly.const(ctx.params, r, device) for r in lvl)
    return out


def decode_ciphertext_outputs(ctx: RingGswContext, ct: RingGswCiphertext, results, pos=0):
    """Decode evaluated output wires back to a native 2 x width int matrix."""
    native = []
    for row in ct.rows:
        out_row = []
        for e in row:
            vals = []
            for lvl in range(e.levels):
                vals.append(
                    [results[pos + i].const_coeff() for i in range(ctx.nested.k)]
                )
                pos += ctx.nested.k
            out_row.append(decode_nested_rns_outputs(ctx.nested, vals) % ctx.q_big)
        native.append(out_row)
    return native, pos
