"""Carry-propagation big-integer arithmetic and Montgomery modular
multiplication, in-circuit: a copy of
`mxx_tpu/gadgets/arith/carry_montgomery.py` (host code that builds gates).

The alternative to nested RNS: an integer is base-2^b limb wires, additions
and multiplications accumulate raw limb values, and LUTs split them into
(low limb, carry) during normalization. Montgomery reduction (REDC) runs
limb-wise over the same machinery:

    m = (T mod R) * N' mod R,    t = (T + m N) / R,   R = 2^{b*k}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...circuit import PolyCircuit
from ...lookup import PublicLut
from ...ring.element import FinRingElem
from ...utils.numth import modinv


class CarryArithContext:
    def __init__(self, circuit: PolyCircuit, params, limb_bits: int, num_limbs: int):
        self.params = params
        self.limb_bits = limb_bits
        self.num_limbs = num_limbs
        self.base = 1 << limb_bits
        # domain covers schoolbook accumulations: num_limbs products of
        # (base-1)^2 plus carries
        self.domain = (self.base - 1) ** 2 * (num_limbs + 2)
        q = params.modulus
        assert self.domain < q, "carry-arith LUT domain exceeds ring modulus"

        def lut(fn):
            return circuit.register_public_lut(
                PublicLut(
                    params,
                    self.domain,
                    lambda _p, t, fn=fn: (t, FinRingElem(fn(t), q)) if t < self.domain else None,
                    max_output_row=(0, FinRingElem(0, q)),
                )
            )

        self.lut_lo = lut(lambda t: t % self.base)
        self.lut_hi = lut(lambda t: t // self.base)


@dataclass
class CarryArithPoly:
    """Little-endian limb wires with per-limb value bounds."""

    ctx: CarryArithContext
    limbs: list[int]
    bounds: list[int] = field(default_factory=list)

    @staticmethod
    def input(ctx: CarryArithContext, circuit: PolyCircuit) -> "CarryArithPoly":
        wires = circuit.input(ctx.num_limbs)
        return CarryArithPoly(ctx, wires, [ctx.base - 1] * ctx.num_limbs)

    @staticmethod
    def encode(ctx: CarryArithContext, value: int) -> list[int]:
        out = []
        for _ in range(ctx.num_limbs):
            out.append(value % ctx.base)
            value //= ctx.base
        assert value == 0, "value exceeds limb capacity"
        return out

    @staticmethod
    def decode(ctx: CarryArithContext, limb_values: list[int]) -> int:
        acc = 0
        for v in reversed(limb_values):
            acc = acc * ctx.base + int(v)
        return acc

    def add(self, other: "CarryArithPoly", circuit: PolyCircuit) -> "CarryArithPoly":
        limbs = [circuit.add_gate(a, b) for a, b in zip(self.limbs, other.limbs)]
        bounds = [a + b for a, b in zip(self.bounds, other.bounds)]
        out = CarryArithPoly(self.ctx, limbs, bounds)
        if max(bounds) >= self.ctx.domain // 2:
            out = out.normalize(circuit)
        return out

    def normalize(self, circuit: PolyCircuit) -> "CarryArithPoly":
        """Carry-propagate so every limb is < base."""
        ctx = self.ctx
        limbs = []
        carry = None
        for i, w in enumerate(self.limbs):
            v = w if carry is None else circuit.add_gate(w, carry)
            limbs.append(circuit.public_lookup_gate(v, ctx.lut_lo))
            carry = circuit.public_lookup_gate(v, ctx.lut_hi)
        # top carry drops (values must fit num_limbs; callers size accordingly)
        return CarryArithPoly(ctx, limbs, [ctx.base - 1] * ctx.num_limbs)

    def mul(self, other: "CarryArithPoly", circuit: PolyCircuit) -> "CarryArithPoly":
        """Schoolbook product truncated to num_limbs (callers manage width),
        with per-column normalization."""
        ctx = self.ctx
        a = self.normalize(circuit) if max(self.bounds) >= ctx.base else self
        b = other.normalize(circuit) if max(other.bounds) >= ctx.base else other
        cols: list[list[int]] = [[] for _ in range(ctx.num_limbs)]
        for i in range(ctx.num_limbs):
            for j in range(ctx.num_limbs - i):
                cols[i + j].append(circuit.mul_gate(a.limbs[i], b.limbs[j]))
        limbs = []
        carry = None
        for col in cols:
            acc = carry
            for t in col:
                acc = t if acc is None else circuit.add_gate(acc, t)
            if acc is None:
                acc = circuit.const_zero_gate()
            limbs.append(circuit.public_lookup_gate(acc, ctx.lut_lo))
            carry = circuit.public_lookup_gate(acc, ctx.lut_hi)
        return CarryArithPoly(ctx, limbs, [ctx.base - 1] * ctx.num_limbs)


class MontgomeryContext:
    """Montgomery modular arithmetic over CarryArithPoly limbs."""

    def __init__(self, arith: CarryArithContext, modulus: int):
        self.arith = arith
        self.n = modulus
        self.r = arith.base**arith.num_limbs
        assert modulus % 2 == 1 and modulus < self.r
        self.n_prime = (-modinv(modulus, self.r)) % self.r
        self.r2 = self.r * self.r % modulus

    def to_mont_value(self, v: int) -> int:
        return v * self.r % self.n

    def from_mont_value(self, v: int) -> int:
        return v * modinv(self.r, self.n) % self.n

    def redc(self, t_lo: CarryArithPoly, t_hi: CarryArithPoly,
             circuit: PolyCircuit) -> CarryArithPoly:
        """REDC of T = t_hi * R + t_lo (< N*R): returns T * R^{-1} mod N
        (up to one conditional subtraction, bounded < 2N)."""
        ctx = self.arith
        np_limbs = CarryArithPoly(
            ctx,
            [circuit.const_digits([d]) for d in CarryArithPoly.encode(ctx, self.n_prime)],
            [ctx.base - 1] * ctx.num_limbs,
        )
        n_limbs = CarryArithPoly(
            ctx,
            [circuit.const_digits([d]) for d in CarryArithPoly.encode(ctx, self.n)],
            [ctx.base - 1] * ctx.num_limbs,
        )
        m = t_lo.mul(np_limbs, circuit)  # (T mod R) * N' mod R
        mn = m.mul_full(n_limbs, circuit)  # 2k limbs of m*N
        # t = (T + m*N) / R: low k limbs of T + mN vanish; result = hi halves + carry
        k = ctx.num_limbs
        lo_sum_carry = _carry_out_of_low_half(t_lo, mn[:k], circuit, ctx)
        hi = []
        carry = lo_sum_carry
        for i in range(k):
            v = circuit.add_gate(t_hi.limbs[i], mn[k + i])
            v = circuit.add_gate(v, carry) if carry is not None else v
            hi.append(circuit.public_lookup_gate(v, ctx.lut_lo))
            carry = circuit.public_lookup_gate(v, ctx.lut_hi)
        return CarryArithPoly(ctx, hi, [ctx.base - 1] * k)

    def mont_mul(self, a: CarryArithPoly, b: CarryArithPoly,
                 circuit: PolyCircuit) -> CarryArithPoly:
        lo, hi = a.mul_split(b, circuit)
        return self.redc(lo, hi, circuit)


def _carry_out_of_low_half(t_lo: CarryArithPoly, mn_low: list[int], circuit, ctx):
    carry = None
    for i in range(ctx.num_limbs):
        v = circuit.add_gate(t_lo.limbs[i], mn_low[i])
        if carry is not None:
            v = circuit.add_gate(v, carry)
        carry = circuit.public_lookup_gate(v, ctx.lut_hi)
    return carry


def _mul_full(self, other: "CarryArithPoly", circuit: PolyCircuit) -> list[int]:
    """Full 2k-limb schoolbook product wire list (normalized limbs)."""
    ctx = self.ctx
    a = self.normalize(circuit) if max(self.bounds) >= ctx.base else self
    b = other.normalize(circuit) if max(other.bounds) >= ctx.base else other
    k = ctx.num_limbs
    cols: list[list[int]] = [[] for _ in range(2 * k)]
    for i in range(k):
        for j in range(k):
            cols[i + j].append(circuit.mul_gate(a.limbs[i], b.limbs[j]))
    limbs = []
    carry = None
    for col in cols:
        acc = carry
        for t in col:
            acc = t if acc is None else circuit.add_gate(acc, t)
        if acc is None:
            acc = circuit.const_zero_gate()
        limbs.append(circuit.public_lookup_gate(acc, ctx.lut_lo))
        carry = circuit.public_lookup_gate(acc, ctx.lut_hi)
    return limbs


def _mul_split(self, other, circuit):
    full = self.mul_full(other, circuit)
    ctx = self.ctx
    k = ctx.num_limbs
    lo = CarryArithPoly(ctx, full[:k], [ctx.base - 1] * k)
    hi = CarryArithPoly(ctx, full[k:], [ctx.base - 1] * k)
    return lo, hi


CarryArithPoly.mul_full = _mul_full
CarryArithPoly.mul_split = _mul_split
