"""Ring-GSW over slot-packed ring elements: POLYNOMIAL payload keys.

The scalar RingGSW (ring_gsw.py) fixes the payload key to an integer
constant; the reference's key is a ternary RING POLY
(src/io/diamond_io.rs:276-280, ring_gsw.rs). This module is
the packed-ring construction closing that delta: a ciphertext entry is a
ring element of dimension `num_slots` whose coefficients live in the packed
slots of nested-RNS wires, so

- Add/Sub/gadget decomposition apply slot-wise (unchanged nested-RNS ops);
- entry products in the external product are negacyclic convolutions
  (`nested_rns_negacyclic_conv`);
- decryption's key multiplication is the plain-circuit negacyclic conv of
  the PUBLIC combined top half against the secret packed key wire
  (`gadgets.conv_mul.negacyclic_conv_mul`: diagonals from the public side,
  rotations of the key — plaintext-known left operands throughout).

Host-side helpers mirror ring_gsw.py's native bridge with ring-element
entries (C = [a ; k*a + e] + m*G over R_Q = Z_Q[X]/(X^N + 1)).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...circuit import PolyCircuit
from ..arith.nested_rns import (
    NestedRnsPoly,
    encode_nested_rns_value,
    nested_rns_negacyclic_conv,
)
from ..conv_mul import negacyclic_conv_mul
from .ring_gsw import RingGswContext


def subring_stride(params, num_slots: int) -> int:
    """phi: R' = Z_Q[X']/(X'^ns + 1) -> R = Z_Q[X]/(X^n + 1), X' -> X^{n/ns}
    is an exact ring homomorphism (requires ns | n). Returns n / ns."""
    assert params.n % num_slots == 0, (params.n, num_slots)
    return params.n // num_slots


def embed_coeffs(params, coeffs: list[int], num_slots: int) -> list[int]:
    """Host phi-embedding: R' coefficient list -> length-n R coefficient
    list (coefficient s lands at s * n/ns)."""
    stride = subring_stride(params, num_slots)
    out = [0] * params.n
    for s, c in enumerate(coeffs):
        out[s * stride] = c % params.modulus
    return out


def embed_packed_value(circuit: PolyCircuit, params, wire: int, num_slots: int) -> int:
    """In-circuit phi-embedding of a slot-packed value wire (slot s =
    coefficient s of an R' element) into ONE slot-uniform wire carrying
    phi(v) = sum_s v_s X^{s n/ns}: broadcast each slot (repeated slot
    transfer) and shift it by the phi-monomial."""
    from ...circuit import SlotTransferSpec

    stride = subring_stride(params, num_slots)
    acc = None
    for s in range(num_slots):
        b = circuit.slot_transfer_gate_spec(
            wire, SlotTransferSpec.repeated(s, num_slots, 0, None)
        )
        if s:
            mono = [0] * params.n
            mono[s * stride] = 1
            b = circuit.small_scalar_mul(b, mono)
        acc = b if acc is None else circuit.add_gate(acc, b)
    return acc


def packed_decrypt_bit_decomposed_parts(circuit: PolyCircuit, params,
                                        bits: list["PackedRingGswCiphertext"],
                                        negk_wire: int,
                                        plaintext_moduli: list[int],
                                        num_slots: int) -> tuple[int, int]:
    """Split decrypt of a bit-decomposed PACKED mask under a POLY key
    (coeff-major chunk layout bits[coeff * bit_size + bit], coefficients over
    R'): per bit, the combined tops of the ns coefficient ciphertexts are
    phi-embedded, packed with phi-monomials X^{i n/ns}, and multiplied ONCE
    against the phi(-k) key wire — the packed analog of
    noise_refresh.circuit_decrypt.decrypt_bit_decomposed_polynomial_parts
    (reference mask_circuit.rs:123-169 with a ternary ring-poly key)."""
    bit_size = len(plaintext_moduli)
    assert bit_size > 0
    n_coeffs = len(bits) // bit_size
    assert 0 < n_coeffs <= num_slots and n_coeffs * bit_size == len(bits), (
        "chunk must be n_coeffs * bit_size with n_coeffs <= num_slots"
    )
    stride = subring_stride(params, num_slots)
    sd_acc = None
    pb_acc = None
    for bit_idx, t in enumerate(plaintext_moduli):
        top_acc = None
        bot_acc = None
        for coeff in range(n_coeffs):
            ct = bits[coeff * bit_size + bit_idx]
            top, bot = ct.combined_halves(circuit, t)
            top = embed_packed_value(circuit, params, top, num_slots)
            bot = embed_packed_value(circuit, params, bot, num_slots)
            if coeff:
                mono = [0] * params.n
                mono[coeff * stride] = 1
                top = circuit.small_scalar_mul(top, mono)
                bot = circuit.small_scalar_mul(bot, mono)
            top_acc = top if top_acc is None else circuit.add_gate(top_acc, top)
            bot_acc = bot if bot_acc is None else circuit.add_gate(bot_acc, bot)
        sd = circuit.mul_gate(top_acc, negk_wire)
        sd_acc = sd if sd_acc is None else circuit.add_gate(sd_acc, sd)
        pb_acc = bot_acc if pb_acc is None else circuit.add_gate(pb_acc, bot_acc)
    return sd_acc, pb_acc


def ring_mul(a: list[int], b: list[int], q: int) -> list[int]:
    """Host negacyclic product in Z_q[X]/(X^N + 1)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + ai * bj) % q
            else:
                out[k - n] = (out[k - n] - ai * bj) % q
    return out


def native_encrypt_poly(ctx: RingGswContext, k_coeffs: list[int], m_coeffs: list[int],
                        rng, error_sigma: float = 0.0):
    """C = A + m*G over R_Q^{2 x 2L}: A = [a ; k*a + e] with ring-element
    entries (coefficient lists), key (-k, 1) a ring poly. `rng` must be a
    CSPRNG (the a-coefficients are published)."""
    q = ctx.q_big
    n = len(k_coeffs)
    assert len(m_coeffs) == n
    g = ctx.gadget_row()
    L = ctx.gadget_len

    def rand_elem():
        return [rng.randrange(q) for _ in range(n)]

    def err_elem():
        if error_sigma <= 0:
            return [0] * n
        return [round(rng.gauss(0, error_sigma)) % q for _ in range(n)]

    a = [rand_elem() for _ in range(2 * L)]
    row0 = [list(v) for v in a]
    row1 = [
        [(x + e) % q for x, e in zip(ring_mul(k_coeffs, a[j], q), err_elem())]
        for j in range(2 * L)
    ]
    for j in range(L):
        row0[j] = [(v + mc * g[j]) % q for v, mc in zip(row0[j], m_coeffs)]
        row1[L + j] = [(v + mc * g[j]) % q for v, mc in zip(row1[L + j], m_coeffs)]
    return [row0, row1]


def native_decrypt_poly(ctx: RingGswContext, native_ct, k_coeffs: list[int],
                        plaintext_modulus: int) -> list[int]:
    """(-k, 1) . C . G^{-1}((0, Q/t)) = (Q/t) m + e.w over R_Q (host check)."""
    from .ring_gsw import RingGswCiphertext

    q = ctx.q_big
    n = len(k_coeffs)
    L = ctx.gadget_len
    probe = RingGswCiphertext(ctx, ([], []), 1)
    d = probe.gadget_decompose_value_consts(q // plaintext_modulus)
    top = [0] * n
    bottom = [0] * n
    for j, c in enumerate(d):
        top = [(t + c * v) % q for t, v in zip(top, native_ct[0][L + j])]
        bottom = [(t + c * v) % q for t, v in zip(bottom, native_ct[1][L + j])]
    neg_k = [(-c) % q for c in k_coeffs]
    sd = ring_mul(neg_k, top, q)
    return [(s + b) % q for s, b in zip(sd, bottom)]


def native_combined_halves_poly(ctx: RingGswContext, native_ct,
                                plaintext_modulus: int) -> tuple[list[int], list[int]]:
    """Host pre-key decrypt halves (TOP, BOT) of a native packed ciphertext
    as R' elements: -k (x) TOP + BOT = (Q/t) m + e.w."""
    from .ring_gsw import RingGswCiphertext

    q = ctx.q_big
    n = len(native_ct[0][0])
    L = ctx.gadget_len
    probe = RingGswCiphertext(ctx, ([], []), 1)
    d = probe.gadget_decompose_value_consts(q // plaintext_modulus)
    top = [0] * n
    bottom = [0] * n
    for j, c in enumerate(d):
        top = [(t + c * v) % q for t, v in zip(top, native_ct[0][L + j])]
        bottom = [(t + c * v) % q for t, v in zip(bottom, native_ct[1][L + j])]
    return top, bottom


def packed_input_values(ctx: RingGswContext, native_ct) -> list[list[int]]:
    """Per-wire slot-value lists (input order = PackedRingGswCiphertext.input)
    for a native ring-element ciphertext."""
    out: list[list[int]] = []
    for row in native_ct:
        for elem in row:
            per_slot = [encode_nested_rns_value(ctx.nested, v % ctx.q_big) for v in elem]
            levels = len(per_slot[0])
            k = ctx.nested.k
            for lvl in range(levels):
                for i in range(k):
                    out.append([per_slot[s][lvl][i] for s in range(len(elem))])
    return out


@dataclass
class PackedRingGswCiphertext:
    ctx: RingGswContext
    rows: tuple[list[NestedRnsPoly], list[NestedRnsPoly]]
    num_slots: int
    max_plaintext: int = 1

    @staticmethod
    def input(ctx: RingGswContext, circuit: PolyCircuit, num_slots: int,
              max_plaintext: int = 1, canonical: bool = True
              ) -> "PackedRingGswCiphertext":
        rows = tuple(
            [
                NestedRnsPoly.input(ctx.nested, circuit, canonical=canonical)
                for _ in range(ctx.width)
            ]
            for _ in range(2)
        )
        return PackedRingGswCiphertext(ctx, rows, num_slots, max_plaintext)

    @staticmethod
    def from_wires(ctx: RingGswContext, wires, num_slots: int,
                   max_plaintext: int = 1, canonical: bool = True
                   ) -> "PackedRingGswCiphertext":
        """Rebuild from gate ids in `flatten()` order (mirrors
        RingGswCiphertext.from_wires; slot packing lives in the wire VALUES,
        so the wire count per ciphertext is identical to the scalar case).
        `canonical=False` for round-output handoffs."""
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
        return PackedRingGswCiphertext(ctx, rows, num_slots, max_plaintext)

    @property
    def width(self) -> int:
        return len(self.rows[0])

    def flatten(self) -> list[int]:
        return [w for row in self.rows for e in row for w in e.flatten()]

    def add(self, other, circuit):
        rows = tuple(
            [a.add(b, circuit) for a, b in zip(ra, rb)]
            for ra, rb in zip(self.rows, other.rows)
        )
        return PackedRingGswCiphertext(
            self.ctx, rows, self.num_slots, self.max_plaintext + other.max_plaintext
        )

    def mul(self, other: "PackedRingGswCiphertext", circuit: PolyCircuit
            ) -> "PackedRingGswCiphertext":
        """External product C_lhs @ G^{-1}(C_rhs) with RING entry products
        (negacyclic conv across the packed slots)."""
        assert self.num_slots == other.num_slots
        L = self.ctx.gadget_len
        ns = self.num_slots
        out_rows: tuple[list, list] = ([], [])
        for j in range(other.width):
            d0 = other.rows[0][j].gadget_decompose(circuit)
            d1 = other.rows[1][j].gadget_decompose(circuit)
            for i in range(2):
                acc = None
                for t in range(L):
                    term = nested_rns_negacyclic_conv(
                        self.rows[i][t], d0[t], circuit, ns
                    )
                    acc = term if acc is None else acc.add(term, circuit)
                for t in range(L):
                    term = nested_rns_negacyclic_conv(
                        self.rows[i][L + t], d1[t], circuit, ns
                    )
                    acc = acc.add(term, circuit)
                out_rows[i].append(acc.full_reduce(circuit))
        return PackedRingGswCiphertext(
            self.ctx, out_rows, ns, self.max_plaintext * other.max_plaintext
        )

    def sub(self, other, circuit):
        rows = tuple(
            [a.sub(b, circuit) for a, b in zip(ra, rb)]
            for ra, rb in zip(self.rows, other.rows)
        )
        return PackedRingGswCiphertext(
            self.ctx, rows, self.num_slots, self.max_plaintext + other.max_plaintext
        )

    def and_(self, other, circuit):
        """Boolean AND for DEGREE-0 (constant) bit plaintexts: the ring
        product of two constants is the scalar product, so the scalar GSW's
        boolean algebra carries over unchanged — the packing lives in the
        CIPHERTEXT entries (ring elements under the poly key), exactly the
        reference's seed-bit semantics (ring_gsw.rs:1297-1330)."""
        assert self.max_plaintext == 1 and other.max_plaintext == 1
        return self.mul(other, circuit)

    def xor(self, other, circuit):
        assert self.max_plaintext == 1 and other.max_plaintext == 1
        s = self.add(other, circuit)
        p = self.mul(other, circuit)
        out = s.sub(p, circuit).sub(p, circuit)
        return PackedRingGswCiphertext(out.ctx, out.rows, out.num_slots, 1)

    def reduced(self, circuit: PolyCircuit) -> "PackedRingGswCiphertext":
        """Full-reduce out-of-bound entries (circuit-boundary form; see
        RingGswCiphertext.reduced)."""
        from .ring_gsw import _entry_reduced

        rows = tuple(
            [_entry_reduced(e, circuit) for e in row] for row in self.rows
        )
        return PackedRingGswCiphertext(
            self.ctx, rows, self.num_slots, self.max_plaintext
        )

    def combined_halves(self, circuit: PolyCircuit, plaintext_modulus: int
                        ) -> tuple[int, int]:
        """Pre-key decrypt halves (top, bottom) as PACKED value wires (slot
        s = coefficient s of the combined R' element)."""
        from .ring_gsw import RingGswCiphertext

        ctx = self.ctx
        L = ctx.gadget_len
        probe = RingGswCiphertext(ctx, ([], []), 1)
        d_consts = probe.gadget_decompose_value_consts(ctx.q_big // plaintext_modulus)

        def combine(row_half):
            acc = None
            for t, c in enumerate(d_consts):
                term = row_half[t].const_mul(c, circuit)
                acc = term if acc is None else acc.add(term, circuit)
            return acc.reconstruct(circuit)

        return combine(self.rows[0][L:]), combine(self.rows[1][L:])

    def decrypt(self, circuit: PolyCircuit, key_wire: int, plaintext_modulus: int
                ) -> tuple[int, int]:
        """Split decryption: (secret_dependent, public_bottom) PACKED value
        wires whose slot-wise sum is (Q/t) m_s + noise. `key_wire` carries the
        packed ring poly -k; its multiplication is a plain-circuit negacyclic
        conv (public diagonals x key rotations)."""
        top, bottom = self.combined_halves(circuit, plaintext_modulus)
        secret_dependent = negacyclic_conv_mul(circuit, top, key_wire, self.num_slots)
        return secret_dependent, bottom

    def decrypt_embedded(self, circuit: PolyCircuit, params, negk_wire: int,
                         plaintext_modulus: int) -> tuple[int, int]:
        """Split decryption via the SUBRING EMBEDDING phi: R' -> R,
        X' -> X^{n/ns} (exact ring homomorphism since (X^{n/ns})^{ns} = -1):
        the combined packed halves are folded into slot-uniform wires carrying
        phi(TOP), phi(BOT), and the key multiplication is ONE plain mul
        against `negk_wire`, whose plaintext is phi(-k) — the wire the Diamond
        k-channel naturally produces (reference diamond_io.rs key wire:
        decrypt_batch's single mul against the k poly, ring_gsw.rs:1518+).
        Returns slot-uniform (secret_dependent, public_bottom) wires; R'
        coefficient j of the result is R coefficient j*(n/ns)."""
        top, bottom = self.combined_halves(circuit, plaintext_modulus)
        top_hat = embed_packed_value(circuit, params, top, self.num_slots)
        bot_hat = embed_packed_value(circuit, params, bottom, self.num_slots)
        return circuit.mul_gate(top_hat, negk_wire), bot_hat
