"""Nested-RNS in-circuit big-integer arithmetic.

A copy of `mxx_tpu/gadgets/arith/nested_rns.py`, after the reference's nested-RNS gadget
(src/gadgets/arith/nested_rns/{mod.rs,context.rs,encoding.rs,
poly.rs}; SURVEY.md §2.4). An integer x modulo a window of the ring's CRT
moduli q_0..q_{D-1} is represented per q-level as residues in a synthetic
p-RNS basis (pairwise-coprime small p_i), so every circuit wire carries a
small value and all modular reductions become small public LUTs:

- lut_mod_p[i]:   t -> t mod p_i                  (lazy reduction)
- lut_x_to_y[i]:  t -> ((t mod p_i) * (P/p_i)^{-1}) mod p_i
- lut_x_to_real[i]: t -> round((t mod p_i) * inv_i mod p_i * scale / p_i)
- lut_real_to_v:  r -> round(r / scale)

full_reduce of a value v at q-level k (HPS-style base extension):
    y_i = x_i * (P/p_i)^{-1} mod p_i,  v_count = round(sum_i y_i / p_i)
    x' = sum_j y_j * [P_hat_j mod q_k] - v_count * [P mod q_k]
which satisfies x' == v (mod q_k) with 0 <= x' < (sum_i p_i + k) * q_k,
computed wire-wise mod each p_i with small-scalar multiplies.

Differences from the reference (documented simplifications): helper gates are
inlined instead of shared sub-circuits with parameter bindings (a circuit-size
optimization, not a semantic one), and per-level metadata tracks a single
value/trace bound instead of per-wire vectors (conservative).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from ...circuit import PolyCircuit
from ...lookup import PublicLut
from ...ring.element import FinRingElem
from ...utils.numth import modinv

DEFAULT_MAX_UNREDUCED_MULS = 2


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def sample_crt_primes(max_bit_width: int, q_max: int, max_unreduced_muls: int) -> list[int]:
    """First pairwise-coprime moduli in [3, 2^max_bit_width) whose product
    exceeds the unreduced-multiplication budget (reference encoding.rs:38-72;
    deterministic so identical params give identical LUT layouts)."""
    results: list[int] = []
    total = 0
    prod = 1
    for cand in range(3, 1 << max_bit_width):
        if all(_gcd(cand, c) == 1 for c in results):
            results.append(cand)
            total += cand
            prod *= cand
        budget = (total + len(results)) * q_max // 2
        if budget**max_unreduced_muls < prod:
            return results
    raise ValueError(
        f"not enough coprime p-moduli below 2^{max_bit_width} for q_max={q_max}, "
        f"muls={max_unreduced_muls}"
    )


def sample_crt_primes_wide(max_bit_width: int, q_max: int,
                           max_unreduced_muls: int) -> list[int]:
    """Pairwise-coprime moduli chosen DESCENDING from 2^max_bit_width - 1
    until the (headroom-padded) unreduced-multiplication budget holds.

    Deviation from the reference (encoding.rs:38-72 picks the smallest
    moduli ascending): larger moduli reach the budget with fewer basis
    elements, and the basis size k multiplies every nested-RNS wire count
    and enters GSW external products as ~k^2(k+1) gate cost — on this
    build's batched evaluator a k=3 basis makes an in-circuit GSW mul ~6x
    cheaper than the reference-shaped k=6+ basis. The cost is larger LUT
    domains (p_max^2 entries), so "wide" suits secret-oracle/plaintext LUT
    evaluation (tables are free) while "small" suits production LWE/GGH15
    lookup where offline cost is per table entry."""
    results: list[int] = []
    total = 0
    prod = 1
    for cand in range((1 << max_bit_width) - 1, 2, -1):
        if all(_gcd(cand, c) == 1 for c in results):
            results.append(cand)
            total += cand
            prod *= cand
            # factor 4 (vs the ctor's factor-2 headroom): sub() of two
            # full_reduced values needs 2*(sum_p+k)*q + q < P/2, which the
            # small basis covers by overshoot but a tight wide basis must
            # budget explicitly
            if prod > 4 * ((total + len(results) + 1) * q_max) ** max_unreduced_muls:
                return results
    raise ValueError(
        f"not enough coprime wide p-moduli below 2^{max_bit_width} for "
        f"q_max={q_max}, muls={max_unreduced_muls}"
    )


def _round_div(a: int, b: int) -> int:
    return (a + b // 2) // b


def _boundary_bounds(ctx, level_offset: int, active, canonical: bool) -> list[int]:
    if canonical:
        return [q - 1 for q in active]
    return [
        ctx.full_reduce_max_plaintexts[level_offset + i]
        for i in range(len(active))
    ]


class NestedRnsPolyContext:
    """Precomputed constants + registered LUT ids for one configuration."""

    def __init__(self, circuit: PolyCircuit, params, p_moduli_bits: int,
                 max_unreduced_muls: int = DEFAULT_MAX_UNREDUCED_MULS, scale: int | None = None,
                 p_basis: str = "small"):
        self.params = params
        self.p_moduli_bits = p_moduli_bits
        self.max_unreduced_muls = max_unreduced_muls
        self.p_basis = p_basis
        self.q_moduli = list(params.moduli)
        self.q_moduli_depth = len(self.q_moduli)
        q_max = max(self.q_moduli)
        if p_basis == "wide":
            self.p_moduli = sample_crt_primes_wide(p_moduli_bits, q_max, max_unreduced_muls)
        else:
            assert p_basis == "small", p_basis
            self.p_moduli = sample_crt_primes(p_moduli_bits, q_max, max_unreduced_muls)
        # The reference budget uses centered residues (bound/2); our residues
        # are canonical non-negative, so extend the basis until
        # P > ((sum p_i + k + 1) * q_max)^muls holds for the looser bound.
        candidate = 3
        while True:
            total = sum(self.p_moduli)
            k = len(self.p_moduli)
            # the HPS v-rounding in full_reduce/reconstruct/gadget_decompose
            # (real_to_v LUT) is exact only for represented values < P/2, so
            # the basis must leave a factor-2 headroom over the op budgets
            if math.prod(self.p_moduli) > 2 * ((total + k + 1) * q_max) ** max_unreduced_muls:
                break
            while not all(_gcd(candidate, c) == 1 for c in self.p_moduli):
                candidate += 1
                if candidate >= (1 << p_moduli_bits):
                    raise ValueError("cannot extend p-moduli basis within bit width")
            self.p_moduli.append(candidate)
        self.k = len(self.p_moduli)
        self.p_full = math.prod(self.p_moduli)
        # exactness ceiling for every represented value (see v-rounding note)
        self.p_half = self.p_full // 2
        self.p_over_pis = [self.p_full // p for p in self.p_moduli]
        self.p_max = max(self.p_moduli)
        # value bound after one full_reduce: (sum p_i + k) * q  (context.rs:55-79)
        self.sum_p = sum(self.p_moduli)
        self.full_reduce_max_plaintexts = [
            (self.sum_p + self.k) * q for q in self.q_moduli
        ]
        # Wire plaintexts live modulo the RING modulus, so every intermediate
        # value (LUT domains, rounding scale sums) must stay below it.
        ring_q = params.modulus
        if scale is None:
            scale = min(1 << 16, (ring_q - 1) // (self.k + 2))
        self.scale = scale
        # rounding precision: k/(2*scale) must leave margin below 1/2
        assert self.k < self.scale, "rounding scale too small for this p-basis"
        # Uniform LUT domain for mod-p / trace LUTs, covering residue products
        # (p_max^2) and full-reduce accumulations (2k * p_max)
        # (reference context.rs:84-86 lut_mod_p_map_size, made uniform here).
        domain = max(self.p_max * self.p_max, 2 * self.k * self.p_max) + self.p_max
        assert domain < ring_q, (
            f"nested-RNS LUT domain {domain} exceeds ring modulus {ring_q}; "
            "increase crt_bits/depth or lower p_moduli_bits"
        )
        assert self.k * self.scale + 1 < ring_q
        self.lut_mod_p_domain = [domain] * self.k
        # full-reduce scalar tables (context.rs:151-181):
        # scalars_y[q][i][j] = (P/p_j mod q) mod p_i ; scalars_v[q][i] = (P mod q) mod p_i
        self.scalars_y = [
            [
                [(self.p_over_pis[j] % q) % p_i for j in range(self.k)]
                for p_i in self.p_moduli
            ]
            for q in self.q_moduli
        ]
        self.scalars_v = [
            [(self.p_full % q) % p_i for p_i in self.p_moduli] for q in self.q_moduli
        ]
        # gadget values per q-level: [P_hat_j mod q ...] + [q - (P mod q)]
        self.gadget_values = []
        for q in self.q_moduli:
            row = [ph % q for ph in self.p_over_pis]
            pm = self.p_full % q
            row.append(0 if pm == 0 else q - pm)
            self.gadget_values.append(row)
        self._register_luts(circuit)
        # LUT ids above index into this registry; fresh circuits built against
        # this context must share it (reference RingGswContext::fresh_circuit)
        self.luts = circuit.luts

    def fresh_circuit(self) -> PolyCircuit:
        """New circuit sharing this context's LUT registry, so sub-circuits
        built later (decrypt/PRG material) resolve the context's lut ids."""
        c = PolyCircuit()
        c.luts = self.luts
        return c

    # ------------------------------------------------------------------ LUTs

    def _register_luts(self, circuit: PolyCircuit):
        params = self.params
        qmod = params.modulus

        def make_lut(length, fn):
            return circuit.register_public_lut(
                PublicLut(
                    params,
                    length,
                    lambda _p, t, fn=fn, length=length: (
                        (t, FinRingElem(fn(t), qmod)) if t < length else None
                    ),
                    max_output_row=(0, FinRingElem(0, qmod)),
                )
            )

        self.lut_mod_p_ids = [
            make_lut(self.lut_mod_p_domain[i], lambda t, p=p: t % p)
            for i, p in enumerate(self.p_moduli)
        ]
        self.lut_x_to_y_ids = []
        self.lut_x_to_real_ids = []
        for i, p in enumerate(self.p_moduli):
            inv = modinv(self.p_full // p % p, p)
            dom = self.lut_mod_p_domain[i]
            self.lut_x_to_y_ids.append(make_lut(dom, lambda t, p=p, inv=inv: (t % p) * inv % p))
            self.lut_x_to_real_ids.append(
                make_lut(
                    dom,
                    lambda t, p=p, inv=inv, s=self.scale: _round_div((t % p) * inv % p * s, p),
                )
            )
        self.lut_real_to_v_id = make_lut(
            self.k * self.scale + 1, lambda r: _round_div(r, self.scale)
        )

    def decomposition_len(self) -> int:
        return self.k + 1

    def active_q(self, level_offset: int, enable_levels: int | None) -> list[int]:
        levels = enable_levels if enable_levels is not None else self.q_moduli_depth - level_offset
        return self.q_moduli[level_offset : level_offset + levels]

    def reconstruction_coeffs(self, level_offset: int = 0, enable_levels: int | None = None):
        """CRT coefficients for the active window (encoding.rs:166-183)."""
        active = self.active_q(level_offset, enable_levels)
        modulus = math.prod(active)
        out = []
        for q in active:
            qh = modulus // q
            out.append(qh * modinv(qh % q, q) % modulus)
        return out, modulus


# ------------------------------------------------------------------ encoding


def encode_nested_rns_value(ctx: NestedRnsPolyContext, value: int,
                            level_offset: int = 0, enable_levels: int | None = None):
    """Plain-int residue table [q_level][p_idx] for a circuit input."""
    active = ctx.active_q(level_offset, enable_levels)
    return [[(value % q) % p for p in ctx.p_moduli] for q in active]


def decode_nested_rns_outputs(ctx: NestedRnsPolyContext, residues,
                              level_offset: int = 0, enable_levels: int | None = None) -> int:
    """Reconstruct the represented integer from output wire values
    [q_level][p_idx] (each possibly unreduced mod p_i)."""
    active = ctx.active_q(level_offset, enable_levels)
    coeffs, modulus = ctx.reconstruction_coeffs(level_offset, enable_levels)
    acc = 0
    for lvl, q in enumerate(active):
        row = [int(r) % p for r, p in zip(residues[lvl], ctx.p_moduli)]
        v = 0
        for r, p, ph in zip(row, ctx.p_moduli, ctx.p_over_pis):
            v += r * modinv(ph % p, p) % p * ph
        v %= ctx.p_full
        acc += (v % q) * coeffs[lvl]
    return acc % modulus


# ------------------------------------------------------------------ the wire


@dataclass
class NestedRnsPoly:
    """Per-q-level p-residue wires plus conservative bounds metadata."""

    ctx: NestedRnsPolyContext
    wires: list[list[int]]  # [q_level][p_idx] gate ids
    level_offset: int = 0
    enable_levels: int | None = None
    value_bounds: list[int] = field(default_factory=list)  # represented-integer bound per level
    trace_bounds: list[int] = field(default_factory=list)  # wire plaintext bound per level

    @property
    def levels(self) -> int:
        return len(self.wires)

    @staticmethod
    def input(ctx: NestedRnsPolyContext, circuit: PolyCircuit,
              level_offset: int = 0, enable_levels: int | None = None,
              canonical: bool = True) -> "NestedRnsPoly":
        """Fresh input wires.

        `canonical=True` (fresh native lifts): level values < q, the tight
        bound. `canonical=False` (circuit-boundary HANDOFF of round outputs
        that ended with full_reduce — see RingGswCiphertext.reduced): level
        representatives up to the full-reduce bound (sum_p + k) * q, traces
        < p_max. Assuming q-1 for handoff wires silently under-provisioned
        LUT reductions (real-mode round outputs overflowed LUT domains)."""
        active = ctx.active_q(level_offset, enable_levels)
        wires = [circuit.input(ctx.k) for _ in active]
        return NestedRnsPoly(
            ctx, wires, level_offset, enable_levels,
            value_bounds=_boundary_bounds(ctx, level_offset, active, canonical),
            trace_bounds=[ctx.p_max - 1] * len(active),
        )

    @staticmethod
    def from_wires(ctx: NestedRnsPolyContext, circuit_wires,
                   level_offset: int = 0, enable_levels: int | None = None,
                   canonical: bool = True) -> "NestedRnsPoly":
        """Rebuild a nested poly from existing gate ids in `flatten()` order
        (wires produced by input gates, const gates, or sub-circuit calls).
        Same canonical/handoff bound switch as `input` (see there)."""
        active = ctx.active_q(level_offset, enable_levels)
        k = ctx.k
        ids = list(circuit_wires)
        assert len(ids) == len(active) * k, (len(ids), len(active), k)
        wires = [ids[lvl * k : (lvl + 1) * k] for lvl in range(len(active))]
        return NestedRnsPoly(
            ctx, wires, level_offset, enable_levels,
            value_bounds=_boundary_bounds(ctx, level_offset, active, canonical),
            trace_bounds=[ctx.p_max - 1] * len(active),
        )

    def flatten(self) -> list[int]:
        return [w for lvl in self.wires for w in lvl]

    def _check_compat(self, other: "NestedRnsPoly"):
        assert self.ctx is other.ctx and self.levels == other.levels
        assert self.level_offset == other.level_offset

    # ------------------------------------------------------------ arithmetic

    def lazy_reduce(self, circuit: PolyCircuit) -> "NestedRnsPoly":
        """Reduce every wire mod its p_i via LUT (context.rs lazy_reduce)."""
        new_wires = []
        for lvl in self.wires:
            new_wires.append(
                [
                    circuit.public_lookup_gate(w, self.ctx.lut_mod_p_ids[i])
                    for i, w in enumerate(lvl)
                ]
            )
        return replace(
            self, wires=new_wires, trace_bounds=[self.ctx.p_max - 1] * self.levels
        )

    def _maybe_lazy(self, circuit, projected_traces) -> "NestedRnsPoly":
        limit = min(self.ctx.lut_mod_p_domain)
        if any(t >= limit for t in projected_traces):
            return self.lazy_reduce(circuit)
        return self

    def _active_moduli(self) -> list[int]:
        return self.ctx.active_q(self.level_offset, self.enable_levels)

    def add(self, other: "NestedRnsPoly", circuit: PolyCircuit) -> "NestedRnsPoly":
        self._check_compat(other)
        a, b = self, other
        if any(va + vb >= self.ctx.p_half for va, vb in zip(a.value_bounds, b.value_bounds)):
            a = a.full_reduce(circuit)
            b = b.full_reduce(circuit)
        limit = min(self.ctx.lut_mod_p_domain)
        if any(ta + tb >= limit for ta, tb in zip(a.trace_bounds, b.trace_bounds)):
            a = a.lazy_reduce(circuit)
            b = b.lazy_reduce(circuit)
        wires = [
            [circuit.add_gate(x, y) for x, y in zip(la, lb)]
            for la, lb in zip(a.wires, b.wires)
        ]
        return replace(
            self,
            wires=wires,
            value_bounds=[va + vb for va, vb in zip(a.value_bounds, b.value_bounds)],
            trace_bounds=[ta + tb for ta, tb in zip(a.trace_bounds, b.trace_bounds)],
        )

    def sub(self, other: "NestedRnsPoly", circuit: PolyCircuit) -> "NestedRnsPoly":
        """Exact integer subtraction with per-level q_i value offsets: computes
        a + c*q_i - b with c = ceil(b_bound / q_i), so the represented value
        stays non-negative (no p-CRT wrap) and stays congruent mod q_i. Wire
        traces get an extra +p_i offset to remain non-negative plaintexts
        (reference poly.rs:349-382 + context.rs sub_with_trace_offsets)."""
        self._check_compat(other)
        a, b = self, other
        qs = self._active_moduli()
        if any(
            va + (-(-vb // q) * q) + q >= self.ctx.p_half
            for va, vb, q in zip(a.value_bounds, b.value_bounds, qs)
        ):
            a = a.full_reduce(circuit)
            b = b.full_reduce(circuit)
        b = b.lazy_reduce(circuit)
        wires = []
        new_val = []
        for lvl_idx, (la, lb) in enumerate(zip(a.wires, b.wires)):
            q_i = qs[lvl_idx]
            c = -(-b.value_bounds[lvl_idx] // q_i)
            lvl = []
            for i, (x, y) in enumerate(zip(la, lb)):
                p_i = self.ctx.p_moduli[i]
                off = (c * q_i) % p_i + p_i
                t = circuit.add_gate(x, circuit.const_digits([off]))
                lvl.append(circuit.sub_gate(t, y))
            wires.append(lvl)
            new_val.append(a.value_bounds[lvl_idx] + c * q_i)
        assert all(v < self.ctx.p_half for v in new_val), "sub exceeds p-CRT budget"
        return replace(
            self,
            wires=wires,
            value_bounds=new_val,
            trace_bounds=[t + 2 * self.ctx.p_max for t in a.trace_bounds],
        )

    def mul(self, other: "NestedRnsPoly", circuit: PolyCircuit) -> "NestedRnsPoly":
        self._check_compat(other)
        a, b = self, other
        if any(va * vb >= self.ctx.p_half for va, vb in zip(a.value_bounds, b.value_bounds)):
            a = a.full_reduce(circuit)
            b = b.full_reduce(circuit)
        if max(a.trace_bounds) >= self.ctx.p_max:
            a = a.lazy_reduce(circuit)
        if max(b.trace_bounds) >= self.ctx.p_max:
            b = b.lazy_reduce(circuit)
        new_val = [va * vb for va, vb in zip(a.value_bounds, b.value_bounds)]
        assert all(v < self.ctx.p_half for v in new_val), (
            "nested-RNS multiplication exceeds the p-CRT budget even after full_reduce"
        )
        wires = []
        for la, lb in zip(a.wires, b.wires):
            lvl = []
            for i, (x, y) in enumerate(zip(la, lb)):
                prod = circuit.mul_gate(x, y)
                lvl.append(circuit.public_lookup_gate(prod, self.ctx.lut_mod_p_ids[i]))
            wires.append(lvl)
        return replace(
            self,
            wires=wires,
            value_bounds=new_val,
            trace_bounds=[self.ctx.p_max - 1] * self.levels,
        )

    def const_mul(self, c: int, circuit: PolyCircuit) -> "NestedRnsPoly":
        """Multiply by a small non-negative integer constant (wire-wise
        small-scalar multiplies by c mod p_i, with budget tracking)."""
        assert c >= 0
        if c == 0:
            zero_wires = [
                [circuit.const_zero_gate() for _ in lvl] for lvl in self.wires
            ]
            return replace(
                self,
                wires=zero_wires,
                value_bounds=[0] * self.levels,
                trace_bounds=[0] * self.levels,
            )
        a = self
        if any(v * c >= self.ctx.p_half for v in a.value_bounds):
            a = a.full_reduce(circuit)
        if max(a.trace_bounds) * min(c, self.ctx.p_max) >= min(self.ctx.lut_mod_p_domain):
            a = a.lazy_reduce(circuit)
        wires = []
        for lvl in a.wires:
            out = []
            for i, w in enumerate(lvl):
                ci = c % self.ctx.p_moduli[i]
                if ci == 0:
                    out.append(circuit.const_zero_gate())
                else:
                    out.append(circuit.public_lookup_gate(
                        circuit.small_scalar_mul(w, [ci]), self.ctx.lut_mod_p_ids[i]
                    ))
            wires.append(out)
        return replace(
            self,
            wires=wires,
            value_bounds=[v * c for v in a.value_bounds],
            trace_bounds=[self.ctx.p_max - 1] * self.levels,
        )

    def full_reduce(self, circuit: PolyCircuit) -> "NestedRnsPoly":
        """HPS base extension per q-level (context.rs full_reduce_subcircuit)."""
        ctx = self.ctx
        active = ctx.active_q(self.level_offset, self.enable_levels)
        reduced = self.lazy_reduce(circuit)
        new_wires = []
        for lvl_idx, lvl in enumerate(reduced.wires):
            q_idx = self.level_offset + lvl_idx
            ys = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_y_ids[i])
                for i, w in enumerate(lvl)
            ]
            reals = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_real_ids[i])
                for i, w in enumerate(lvl)
            ]
            real_sum = reals[0]
            for r in reals[1:]:
                real_sum = circuit.add_gate(real_sum, r)
            v = circuit.public_lookup_gate(real_sum, ctx.lut_real_to_v_id)
            lvl_out = []
            for i, p_i in enumerate(ctx.p_moduli):
                acc = None
                for j, y_j in enumerate(ys):
                    term = circuit.small_scalar_mul(y_j, [ctx.scalars_y[q_idx][i][j]])
                    term = circuit.public_lookup_gate(term, ctx.lut_mod_p_ids[i])
                    acc = term if acc is None else circuit.add_gate(acc, term)
                v_term = circuit.small_scalar_mul(v, [ctx.scalars_v[q_idx][i]])
                offset = circuit.const_digits([ctx.k * p_i])
                acc = circuit.add_gate(acc, offset)
                acc = circuit.sub_gate(acc, v_term)
                lvl_out.append(circuit.public_lookup_gate(acc, ctx.lut_mod_p_ids[i]))
            new_wires.append(lvl_out)
        return replace(
            self,
            wires=new_wires,
            value_bounds=[
                ctx.full_reduce_max_plaintexts[self.level_offset + i]
                for i in range(len(active))
            ],
            trace_bounds=[ctx.p_max - 1] * len(active),
        )

    def const_mul_per_level(self, consts: list[int], circuit: PolyCircuit
                            ) -> "NestedRnsPoly":
        """Multiply level i by its own small constant (needed by mod-switch:
        the q_L^{-1} mod q_i factors differ per level)."""
        assert len(consts) == self.levels
        a = self
        if any(v * c >= self.ctx.p_half for v, c in zip(a.value_bounds, consts)):
            a = a.full_reduce(circuit)
        if max(a.trace_bounds) * min(max(consts), self.ctx.p_max) >= min(
            self.ctx.lut_mod_p_domain
        ):
            a = a.lazy_reduce(circuit)
        wires = []
        for lvl, c in zip(a.wires, consts):
            out = []
            for i, w in enumerate(lvl):
                ci = c % self.ctx.p_moduli[i]
                if ci == 0:
                    out.append(circuit.const_zero_gate())
                else:
                    out.append(circuit.public_lookup_gate(
                        circuit.small_scalar_mul(w, [ci]), self.ctx.lut_mod_p_ids[i]
                    ))
            wires.append(out)
        return replace(
            self,
            wires=wires,
            value_bounds=[v * c for v, c in zip(a.value_bounds, consts)],
            trace_bounds=[self.ctx.p_max - 1] * self.levels,
        )

    def _level_as_value(self, lvl_idx: int, target_offset: int,
                        target_levels: int) -> "NestedRnsPoly":
        """Reinterpret one reduced level's p-slot wires as the SAME integer at
        a different q-window: the p-RNS representation is level-agnostic (it
        encodes an integer < P), so the wires are shared, only the window
        metadata changes. Caller must have full_reduced first."""
        bound = self.value_bounds[lvl_idx]
        return replace(
            self,
            wires=[list(self.wires[lvl_idx]) for _ in range(target_levels)],
            level_offset=target_offset,
            enable_levels=target_levels,
            value_bounds=[bound] * target_levels,
            trace_bounds=[self.trace_bounds[lvl_idx]] * target_levels,
        )

    def mod_down_one_level(self, circuit: PolyCircuit, drop_first: bool = False
                           ) -> "NestedRnsPoly":
        """CKKS-style branchwise rescale: drop one q-level L (last by default,
        first for relinearization P-removal) and output
        (a_i - [a]_{q_L}) * q_L^{-1} mod q_i on the kept window
        (reference mod_switch/nested_rns.rs mod_down_one_level)."""
        from ...utils.numth import modinv

        assert self.levels > 1, "mod_down needs at least two active levels"
        a = self.full_reduce(circuit)
        qs = self._active_moduli()
        drop_idx = 0 if drop_first else self.levels - 1
        q_drop = qs[drop_idx]
        keep_offset = self.level_offset + (1 if drop_first else 0)
        keep_levels = self.levels - 1
        r = a._level_as_value(drop_idx, keep_offset, keep_levels)
        kept = replace(
            a,
            wires=[lvl for i, lvl in enumerate(a.wires) if i != drop_idx],
            level_offset=keep_offset,
            enable_levels=keep_levels,
            value_bounds=[v for i, v in enumerate(a.value_bounds) if i != drop_idx],
            trace_bounds=[t for i, t in enumerate(a.trace_bounds) if i != drop_idx],
        )
        diff = kept.sub(r, circuit)
        kept_qs = [q for i, q in enumerate(qs) if i != drop_idx]
        invs = [modinv(q_drop % q_i, q_i) for q_i in kept_qs]
        return diff.const_mul_per_level(invs, circuit)

    def mod_up_front(self, circuit: PolyCircuit, extra: int) -> "NestedRnsPoly":
        """HPS approximate base extension to `extra` additional q-levels in
        front of the window: x_tilde = sum_i [x]_{q_i} (Q/q_i) [(Q/q_i)^{-1}]_{q_i}
        = x + kappa Q, computed per new level j as sum_i r_i * c_ij
        (reference mod_switch/nested_rns.rs mod_up)."""
        from ...utils.numth import modinv

        assert extra > 0
        assert self.level_offset >= extra, "no q-levels available in front"
        a = self.full_reduce(circuit)
        qs = self._active_moduli()
        q_prod = math.prod(qs)
        new_offset = self.level_offset - extra
        new_qs = self.ctx.q_moduli[new_offset : self.level_offset]
        new_wires = []
        new_vals = []
        new_traces = []
        for j, q_j in enumerate(new_qs):
            acc = None
            for i, q_i in enumerate(qs):
                q_hat = q_prod // q_i
                h_i = q_hat * modinv(q_hat % q_i, q_i)  # h_i = (Q/q_i)[(Q/q_i)^{-1}]_{q_i}
                term = a._level_as_value(i, new_offset + j, 1).const_mul(
                    h_i % q_j, circuit
                )
                acc = term if acc is None else acc.add(term, circuit)
            new_wires.append(acc.wires[0])
            new_vals.append(acc.value_bounds[0])
            new_traces.append(acc.trace_bounds[0])
        return replace(
            a,
            wires=new_wires + a.wires,
            level_offset=new_offset,
            enable_levels=extra + self.levels,
            value_bounds=new_vals + a.value_bounds,
            trace_bounds=new_traces + a.trace_bounds,
        )

    # ------------------------------------------------------- reconstruction

    def reconstruct(self, circuit: PolyCircuit) -> int:
        """Collapse all levels to a single wire holding the represented value
        mod the active modulus window (large-scalar combination of the y/w
        decomposition terms; encoding.rs nested_rns_sparse_level_slot_value)."""
        ctx = self.ctx
        coeffs, modulus = ctx.reconstruction_coeffs(self.level_offset, self.enable_levels)
        qmod = ctx.params.modulus
        reduced = self.lazy_reduce(circuit)
        acc = None
        for lvl_idx, lvl in enumerate(reduced.wires):
            ys = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_y_ids[i])
                for i, w in enumerate(lvl)
            ]
            reals = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_real_ids[i])
                for i, w in enumerate(lvl)
            ]
            real_sum = reals[0]
            for r in reals[1:]:
                real_sum = circuit.add_gate(real_sum, r)
            v = circuit.public_lookup_gate(real_sum, ctx.lut_real_to_v_id)
            c = coeffs[lvl_idx]
            for j, y_j in enumerate(ys):
                scalar = ctx.p_over_pis[j] % modulus * c % qmod
                term = circuit.large_scalar_mul(y_j, [scalar])
                acc = term if acc is None else circuit.add_gate(acc, term)
            neg_p = (modulus - ctx.p_full % modulus) * c % qmod
            acc = circuit.add_gate(acc, circuit.large_scalar_mul(v, [neg_p]))
        return acc

    def gadget_scalars(self) -> list[int]:
        """Gadget weights aligned with `gadget_decompose` outputs: for level l
        and term t, g = gadget_values[l][t] * reconst_l mod activeQ, so that
        sum_t term_t * g_t == value (mod activeQ)
        (reference encoding.rs nested_rns_gadget_vector)."""
        ctx = self.ctx
        coeffs, modulus = ctx.reconstruction_coeffs(self.level_offset, self.enable_levels)
        out = []
        for lvl in range(self.levels):
            q_idx = self.level_offset + lvl
            for t in range(ctx.k + 1):
                out.append(ctx.gadget_values[q_idx][t] % modulus * coeffs[lvl] % modulus)
        return out

    def gadget_decompose(self, circuit: PolyCircuit) -> list["NestedRnsPoly"]:
        """Per-level decomposition terms (y_1..y_k, w), each re-encoded as a
        nested-RNS value (context.rs gadget_decompose_subcircuit). Paired with
        `gadget_scalars()` they satisfy sum_t term_t * g_t == value."""
        ctx = self.ctx
        reduced = self.lazy_reduce(circuit)
        outs = []
        for lvl_idx, lvl in enumerate(reduced.wires):
            ys = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_y_ids[i])
                for i, w in enumerate(lvl)
            ]
            reals = [
                circuit.public_lookup_gate(w, ctx.lut_x_to_real_ids[i])
                for i, w in enumerate(lvl)
            ]
            real_sum = reals[0]
            for r in reals[1:]:
                real_sum = circuit.add_gate(real_sum, r)
            v = circuit.public_lookup_gate(real_sum, ctx.lut_real_to_v_id)
            for j, term in enumerate(ys + [v]):
                bound = ctx.p_moduli[j] - 1 if j < ctx.k else ctx.k
                term_wires = [
                    [
                        circuit.public_lookup_gate(term, ctx.lut_mod_p_ids[i])
                        for i in range(ctx.k)
                    ]
                    for _ in range(self.levels)
                ]
                outs.append(
                    replace(
                        self,
                        wires=term_wires,
                        value_bounds=[bound] * self.levels,
                        trace_bounds=[ctx.p_max - 1] * self.levels,
                    )
                )
        return outs


# --------------------------------------------------- slot-packed ring algebra


def _nested_slot_transfer(poly: NestedRnsPoly, circuit: PolyCircuit, spec,
                          bound_scale: int = 1) -> NestedRnsPoly:
    """Apply one slot-transfer spec to every component wire (a permutation /
    scaled selection across packed slots; the nested-RNS structure is
    untouched). `bound_scale` accounts for prefix scalars in the spec."""
    wires = [
        [circuit.slot_transfer_gate_spec(w, spec) for w in lvl]
        for lvl in poly.wires
    ]
    return replace(
        poly,
        wires=wires,
        value_bounds=[v * bound_scale for v in poly.value_bounds],
        trace_bounds=[t * bound_scale for t in poly.trace_bounds],
    )


def nested_rns_negacyclic_conv(a: NestedRnsPoly, b: NestedRnsPoly,
                               circuit: PolyCircuit, num_slots: int
                               ) -> NestedRnsPoly:
    """Negacyclic cross-slot convolution of two SLOT-PACKED nested-RNS ring
    elements (slot i of every component wire carries coefficient i's
    residues): the in-circuit ring multiplication the reference realizes
    through conv_mul over NestedRnsPoly (src/gadgets/conv_mul/mod.rs with
    A = nested-RNS wires) — the building block for Ring-GSW with POLYNOMIAL
    payload keys (ternary ring-poly k).

    Per diagonal d: the signed diagonal diag_d[i] = +-a_d (sign by negacyclic
    wrap) lifts to the represented-value level via the 3*rep - 2*rep2 trick
    (`sub` keeps mod-q congruence with q-multiple offsets, so "negative"
    diagonal values are exact residues), then one nested mul against the
    rotated b and a balanced add tree (gadgets/conv_mul.py is the plain-wire
    sibling)."""
    from ...circuit import SlotTransferSpec

    terms = []
    for d in range(num_slots):
        rep = _nested_slot_transfer(
            a, circuit, SlotTransferSpec.repeated(d, num_slots, 0, None)
        )
        if d == 0:
            diag = rep
        else:
            rep2 = _nested_slot_transfer(
                a, circuit, SlotTransferSpec.repeated(d, num_slots, d, 2),
                bound_scale=2,
            )
            diag = rep.const_mul(3, circuit).sub(rep2.const_mul(2, circuit), circuit)
        rot = _nested_slot_transfer(
            b, circuit, SlotTransferSpec.rotation(d, num_slots)
        )
        terms.append(diag.mul(rot, circuit))
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            nxt.append(terms[i].add(terms[i + 1], circuit))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _level_ntt_stage_wires(ctx, circuit, lvl_wires, specs_left, specs_right):
    """One butterfly stage on a single level's component wires: per-component
    slot transfers (scalars reduced mod p_i so wire traces stay in the mod-p
    LUT domain), a mod-p reduce of the scaled side, then the add."""
    out = []
    for i, w in enumerate(lvl_wires):
        p_i = ctx.p_moduli[i]
        left_i = [(src, None if s is None else s % p_i) for src, s in specs_left]
        right_i = [(src, None if s is None else s % p_i) for src, s in specs_right]
        a = circuit.slot_transfer_gate(w, left_i)
        b = circuit.slot_transfer_gate(w, right_i)
        a = circuit.public_lookup_gate(a, ctx.lut_mod_p_ids[i])
        b = circuit.public_lookup_gate(b, ctx.lut_mod_p_ids[i])
        out.append(circuit.add_gate(a, b))
    return out


def nested_level_ntt(poly: NestedRnsPoly, circuit: PolyCircuit,
                     num_slots: int, inverse: bool = False) -> NestedRnsPoly:
    """In-circuit negacyclic NTT over packed slots, applied independently to
    every q-level with that level's twiddles (q_i = params CRT moduli are
    1 mod 2n, so primitive 2*num_slots-th roots exist for any slot count
    dividing the ring dimension).

    The butterfly structure mirrors gadgets/ntt_circuit.{forward,inverse}_ntt
    (natural -> bit-reversed forward, merged-psi convention of ring/ntt.py);
    the arithmetic runs on nested-RNS wires: per-component slot transfers
    carry the twiddle mod p_i (value congruence survives componentwise
    reduction while the represented value stays below the p-CRT budget), and
    each stage ends in a single-level full_reduce back to a canonical
    residue mod q_level. Requires a context with max_unreduced_muls >= 2
    (stage values reach ~q^2 before the reduce). This is the packed-slot
    domain switch the reference's CKKS keeps disabled
    (src/gadgets/mod.rs:5-6, src/gadgets/ntt/mod.rs:1-16)."""
    from ...utils import numth

    if num_slots == 1:
        return poly
    ctx = poly.ctx
    qs = poly._active_moduli()
    x = poly.full_reduce(circuit)
    x = x.lazy_reduce(circuit)
    out_wires, out_vb, out_tb = [], [], []
    n = num_slots
    ln = n.bit_length() - 1
    assert 1 << ln == n, "num_slots must be a power of two"
    for lvl_idx, q in enumerate(qs):
        psi = numth.find_primitive_2n_root(q, n)
        if inverse:
            psi = numth.modinv(psi, q)
        psi_rev = [pow(psi, numth.bit_reverse(i, ln), q) for i in range(n)]
        lvl = NestedRnsPoly(
            ctx, [list(x.wires[lvl_idx])],
            level_offset=poly.level_offset + lvl_idx, enable_levels=1,
            value_bounds=[x.value_bounds[lvl_idx]],
            trace_bounds=[x.trace_bounds[lvl_idx]],
        )
        if not inverse:
            m, t = 1, n
            while m < n:
                t //= 2
                left, right = [], []
                for slot in range(n):
                    blk, off = divmod(slot, 2 * t)
                    j = blk * 2 * t + (off % t)
                    w = psi_rev[m + blk]
                    left.append((j, None))
                    right.append((j + t, w if off < t else q - w))
                wires = _level_ntt_stage_wires(ctx, circuit, lvl.wires[0],
                                               left, right)
                lvl = replace(
                    lvl, wires=[wires],
                    value_bounds=[lvl.value_bounds[0] * q],
                    trace_bounds=[2 * (ctx.p_max - 1)],
                )
                lvl = lvl.full_reduce(circuit)
                m *= 2
        else:
            t, m = 1, n
            while m > 1:
                h = m // 2
                left, right = [], []
                for slot in range(n):
                    blk, off = divmod(slot, 2 * t)
                    j = blk * 2 * t + (off % t)
                    tw = psi_rev[h + blk]
                    if off < t:
                        left.append((j, None))
                        right.append((j + t, None))
                    else:
                        left.append((j, tw))
                        right.append((j + t, q - tw))
                wires = _level_ntt_stage_wires(ctx, circuit, lvl.wires[0],
                                               left, right)
                lvl = replace(
                    lvl, wires=[wires],
                    value_bounds=[lvl.value_bounds[0] * q],
                    trace_bounds=[2 * (ctx.p_max - 1)],
                )
                lvl = lvl.full_reduce(circuit)
                t *= 2
                m = h
            lvl = lvl.const_mul(numth.modinv(n, q), circuit)
            lvl = lvl.full_reduce(circuit)
        out_wires.append(lvl.wires[0])
        out_vb.append(lvl.value_bounds[0])
        out_tb.append(lvl.trace_bounds[0])
    return replace(x, wires=out_wires, value_bounds=out_vb,
                   trace_bounds=out_tb)
