"""CKKS-style leveled arithmetic inside BGG circuits over nested-RNS wires:
a copy of `mxx_tpu/gadgets/fhe/ckks.py` (host code that builds gates, and
host-integer encrypt/decrypt).

Ciphertexts are pairs (c0, c1) of NestedRnsPoly wires living in a q-level
window offset by `relinearization_extra_levels` (the "P" factor). `mul`
tensors (d0, d1, d2), raises d2 to the full window (ModUp), multiplies by the
two evaluation-key branches, lowers both back (ModDown) and folds them into
(d0, d1). `rescale` drops the last active level branchwise
(mod_down_one_level) in the coefficient domain. With num_slots = 1 the
eval/coeff domain switches are the identity; with num_slots > 1 they run
the nested-RNS in-circuit NTT (`nested_level_ntt`).

Error accounting uses plain-int bounds: per-branch propagated products, the
ModDown remainder slack (the full_reduce residue bound), and the
hidden-quotient term exposed by a branchwise rescale.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

from ...circuit import PolyCircuit
from ..arith.nested_rns import NestedRnsPoly, NestedRnsPolyContext


class CKKSContext:
    def __init__(self, circuit: PolyCircuit, params, p_moduli_bits: int,
                 max_unreduced_muls: int, scale: int,
                 relinearization_extra_levels: int = 1,
                 error_sigma: float = 0.0, num_slots: int = 1):
        assert num_slots >= 1 and (num_slots & (num_slots - 1)) == 0, num_slots
        if num_slots > 1:
            # slot-packed build: domain switches run the nested-RNS
            # in-circuit NTT (nested_level_ntt), which needs the q^2 stage
            # budget
            assert max_unreduced_muls >= 2, (
                "packed CKKS needs max_unreduced_muls >= 2 for the "
                "in-circuit NTT stage budget"
            )
        assert relinearization_extra_levels > 0
        self.params = params
        self.num_slots = num_slots
        self.scale = scale
        self.relin_extra = relinearization_extra_levels
        self.error_sigma = error_sigma
        self.nested = NestedRnsPolyContext(circuit, params, p_moduli_bits,
                                           max_unreduced_muls)
        assert self.nested.q_moduli_depth > relinearization_extra_levels

    @property
    def level_offset(self) -> int:
        return self.relin_extra

    @property
    def max_active_levels(self) -> int:
        return self.nested.q_moduli_depth - self.relin_extra

    def q_window(self, offset: int, levels: int) -> int:
        return math.prod(self.nested.q_moduli[offset : offset + levels])

    def p_factor(self) -> int:
        return math.prod(self.nested.q_moduli[: self.relin_extra])

    def mod_down_slack(self, level_idx: int) -> int:
        """Residue slack of one branchwise level drop."""
        return (
            self.nested.full_reduce_max_plaintexts[level_idx]
            // self.nested.q_moduli[level_idx]
            + 1
        )


@dataclass
class CKKSCiphertext:
    ctx: CKKSContext
    c0: NestedRnsPoly
    c1: NestedRnsPoly
    error_bounds: tuple[int, int] = (0, 0)

    # ------------------------------------------------------------- wiring

    @staticmethod
    def input(ctx: CKKSContext, circuit: PolyCircuit,
              enable_levels: int | None = None) -> "CKKSCiphertext":
        levels = enable_levels if enable_levels is not None else ctx.max_active_levels
        c0 = NestedRnsPoly.input(ctx.nested, circuit, ctx.level_offset, levels)
        c1 = NestedRnsPoly.input(ctx.nested, circuit, ctx.level_offset, levels)
        init = int(math.ceil(6.5 * ctx.error_sigma))
        return CKKSCiphertext(ctx, c0, c1, (init, 0))

    @staticmethod
    def alloc_eval_keys(ctx: CKKSContext, circuit: PolyCircuit) -> "CKKSCiphertext":
        c0 = NestedRnsPoly.input(ctx.nested, circuit, 0, ctx.nested.q_moduli_depth)
        c1 = NestedRnsPoly.input(ctx.nested, circuit, 0, ctx.nested.q_moduli_depth)
        init = int(math.ceil(6.5 * ctx.error_sigma))
        return CKKSCiphertext(ctx, c0, c1, (init, 0))

    def flatten(self) -> list[int]:
        return self.c0.flatten() + self.c1.flatten()

    @property
    def active_levels(self) -> int:
        assert self.c0.levels == self.c1.levels
        return self.c0.levels

    def _signal_bound(self) -> int:
        return self.ctx.q_window(self.c0.level_offset, self.active_levels)

    # ---------------------------------------------------------------- ops

    def add(self, other: "CKKSCiphertext", circuit: PolyCircuit) -> "CKKSCiphertext":
        return CKKSCiphertext(
            self.ctx,
            self.c0.add(other.c0, circuit),
            self.c1.add(other.c1, circuit),
            (self.error_bounds[0] + other.error_bounds[0],
             self.error_bounds[1] + other.error_bounds[1]),
        )

    def mul(self, other: "CKKSCiphertext", eval_keys: "CKKSCiphertext",
            circuit: PolyCircuit) -> "CKKSCiphertext":
        """Tensor, then ModUp, relinearize and ModDown."""
        ctx = self.ctx
        d0 = self.c0.mul(other.c0, circuit)
        d1 = self.c0.mul(other.c1, circuit).add(self.c1.mul(other.c0, circuit), circuit)
        d2 = self.c1.mul(other.c1, circuit)
        ns = ctx.num_slots
        if ns > 1:
            # base conversion acts on integer coefficients: switch d2 to the
            # coefficient domain, ModUp, and return to slot values at the
            # raised window before the (slot-wise = ring) eval-key products
            from ..arith.nested_rns import nested_level_ntt

            d2 = nested_level_ntt(d2, circuit, ns, inverse=True)
        d2_up = d2.mod_up_front(circuit, ctx.relin_extra)
        if ns > 1:
            from ..arith.nested_rns import nested_level_ntt

            d2_up = nested_level_ntt(d2_up, circuit, ns)
        relin0 = d2_up.mul(eval_keys.c0, circuit)
        relin1 = d2_up.mul(eval_keys.c1, circuit)
        if ns > 1:
            from ..arith.nested_rns import nested_level_ntt

            relin0 = nested_level_ntt(relin0, circuit, ns, inverse=True)
            relin1 = nested_level_ntt(relin1, circuit, ns, inverse=True)
        for _ in range(ctx.relin_extra):
            relin0 = relin0.mod_down_one_level(circuit, drop_first=True)
            relin1 = relin1.mod_down_one_level(circuit, drop_first=True)
        if ns > 1:
            from ..arith.nested_rns import nested_level_ntt

            relin0 = nested_level_ntt(relin0, circuit, ns)
            relin1 = nested_level_ntt(relin1, circuit, ns)
        c0 = d0.add(relin0, circuit)
        c1 = d1.add(relin1, circuit)
        n = ctx.num_slots  # ring expansion factor (1 in the scalar build)
        sb, ob = self._signal_bound(), other._signal_bound()
        prod_err = lambda e1, e2: n * (sb * e2 + e1 * ob + e1 * e2)
        moddown_slack = sum(ctx.mod_down_slack(i) for i in range(ctx.relin_extra))
        ek_e = eval_keys.error_bounds[0]
        d2_sig = n * sb * ob
        relin_err = moddown_slack + n * (d2_sig * ek_e)
        return CKKSCiphertext(
            ctx, c0, c1,
            (prod_err(self.error_bounds[0], other.error_bounds[0]) + relin_err,
             prod_err(self.error_bounds[0], other.error_bounds[1])
             + prod_err(self.error_bounds[1], other.error_bounds[0]) + relin_err),
        )

    def rescale(self, circuit: PolyCircuit) -> "CKKSCiphertext":
        """Drop the last active level branchwise."""
        assert self.active_levels > 1
        ctx = self.ctx
        removed_idx = self.c0.level_offset + self.active_levels - 1
        removed = ctx.nested.q_moduli[removed_idx]
        slack = ctx.mod_down_slack(removed_idx)
        coeff = self.to_coeff_domain(circuit)
        e0 = -(-(self.error_bounds[0] + removed) // removed) + slack
        e1 = -(-(self.error_bounds[1] + removed) // removed) + slack
        return CKKSCiphertext(
            ctx,
            coeff.c0.mod_down_one_level(circuit),
            coeff.c1.mod_down_one_level(circuit),
            (e0, e1),
        ).to_eval_domain(circuit)

    def to_coeff_domain(self, circuit: PolyCircuit) -> "CKKSCiphertext":
        """Slot-value (eval) -> coefficient domain: inverse in-circuit NTT
        per component poly (identity for num_slots == 1)."""
        ns = self.ctx.num_slots
        if ns == 1:
            return self
        from ..arith.nested_rns import nested_level_ntt

        return CKKSCiphertext(
            self.ctx,
            nested_level_ntt(self.c0, circuit, ns, inverse=True),
            nested_level_ntt(self.c1, circuit, ns, inverse=True),
            self.error_bounds,
        )

    def to_eval_domain(self, circuit: PolyCircuit) -> "CKKSCiphertext":
        ns = self.ctx.num_slots
        if ns == 1:
            return self
        from ..arith.nested_rns import nested_level_ntt

        return CKKSCiphertext(
            self.ctx,
            nested_level_ntt(self.c0, circuit, ns),
            nested_level_ntt(self.c1, circuit, ns),
            self.error_bounds,
        )


# ----------------------------------------------------------- host helpers


def sample_relinearization_eval_keys(ctx: CKKSContext, secret: int,
                                     rng: random.Random,
                                     error_sigma: float = 0.0) -> tuple[int, int]:
    """(b0, b1) with b0 + b1 s = P s^2 + e over the full window."""
    q_full = ctx.q_window(0, ctx.nested.q_moduli_depth)
    b1 = rng.randrange(q_full)
    e = round(rng.gauss(0, error_sigma)) if error_sigma > 0 else 0
    b0 = (-b1 * secret + e + ctx.p_factor() * secret * secret) % q_full
    return b0, b1


def encrypt(ctx: CKKSContext, secret: int, message: int, rng: random.Random,
            levels: int | None = None, error_sigma: float = 0.0) -> tuple[int, int]:
    """(c0, c1) with c0 + c1 s = scale * message + e in the active window."""
    levels = levels if levels is not None else ctx.max_active_levels
    q = ctx.q_window(ctx.level_offset, levels)
    c1 = rng.randrange(q)
    e = round(rng.gauss(0, error_sigma)) if error_sigma > 0 else 0
    c0 = (ctx.scale * message + e - c1 * secret) % q
    return c0, c1


def decrypt(ctx: CKKSContext, secret: int, c0: int, c1: int, levels: int,
            offset: int | None = None, scale: int | None = None) -> float:
    offset = ctx.level_offset if offset is None else offset
    q = ctx.q_window(offset, levels)
    v = (c0 + c1 * secret) % q
    if v > q // 2:
        v -= q
    return v / (scale if scale is not None else ctx.scale)


def encrypt_packed(ctx: CKKSContext, secret: int, messages: list[int],
                   rng: random.Random, levels: int | None = None,
                   error_sigma: float = 0.0) -> tuple[list[int], list[int]]:
    """Packed encrypt: coefficient vectors (c0, c1) with
    c0[i] + c1[i] * secret = scale * messages[i] + e[i] per coefficient
    (integer secret: the decrypt product is coefficientwise, while
    homomorphic ct x ct products are ring products over the packed slots)."""
    assert len(messages) == ctx.num_slots
    levels = levels if levels is not None else ctx.max_active_levels
    q = ctx.q_window(ctx.level_offset, levels)
    c0, c1 = [], []
    for m_i in messages:
        b = rng.randrange(q)
        e = round(rng.gauss(0, error_sigma)) if error_sigma > 0 else 0
        c1.append(b)
        c0.append((ctx.scale * m_i + e - b * secret) % q)
    return c0, c1


def decrypt_packed(ctx: CKKSContext, secret: int, c0: list[int],
                   c1: list[int], levels: int, offset: int | None = None,
                   scale: int | None = None) -> list[float]:
    return [
        decrypt(ctx, secret, a, b, levels, offset, scale)
        for a, b in zip(c0, c1)
    ]
