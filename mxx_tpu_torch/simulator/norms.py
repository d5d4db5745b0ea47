"""Symbolic norm algebra for error-growth simulation (a copy of
`mxx_tpu/simulator/norms.py`).

Norms are high-precision decimals (the precision is the JAX package's, so
results compare equal across the two packages); `PolyNorm` multiplication
picks up a sqrt(n) factor unless one side is a constant polynomial, and
matrix products scale by sqrt(inner-dim). `ErrorNorm` is the evaluable wire
of `simulate_max_error_norm`: (plaintext bound, encoding-error matrix bound).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from decimal import Decimal, getcontext

getcontext().prec = 80

GAUSSIAN_TAIL_FACTOR = Decimal("6.5")


def bits_ceil(x: Decimal) -> int:
    """ceil(log2(x)) for a positive decimal (0 for x <= 0)."""
    if x <= 0:
        return 0
    return math.ceil(float(x.ln() / Decimal(2).ln()))


@dataclass(frozen=True)
class SimulatorContext:
    ring_dim_sqrt: Decimal
    base: Decimal
    secret_size: int
    log_base_q: int
    log_base_q_small: int

    @property
    def m_g(self) -> int:
        return self.secret_size * self.log_base_q

    @property
    def m_b(self) -> int:
        return self.secret_size * (self.log_base_q + 2)

    @staticmethod
    def for_params(params, secret_size: int) -> "SimulatorContext":
        return SimulatorContext(
            ring_dim_sqrt=Decimal(params.n).sqrt(),
            base=Decimal(1 << params.base_bits),
            secret_size=secret_size,
            log_base_q=params.modulus_digits,
            log_base_q_small=params.digits_per_tower,
        )


@dataclass(frozen=True)
class PolyNorm:
    ctx: SimulatorContext
    norm: Decimal
    is_constant: bool = False

    @staticmethod
    def one(ctx) -> "PolyNorm":
        return PolyNorm(ctx, Decimal(1), True)

    @staticmethod
    def constant(ctx, norm) -> "PolyNorm":
        return PolyNorm(ctx, Decimal(norm), True)

    @staticmethod
    def sample_gauss(ctx, sigma) -> "PolyNorm":
        return PolyNorm(ctx, Decimal(sigma) * GAUSSIAN_TAIL_FACTOR, False)

    def into_constant(self) -> "PolyNorm":
        return replace(self, is_constant=True)

    def __add__(self, other: "PolyNorm") -> "PolyNorm":
        return PolyNorm(self.ctx, self.norm + other.norm, self.is_constant and other.is_constant)

    def __mul__(self, other):
        if isinstance(other, PolyNorm):
            norm = self.norm * other.norm
            if not self.is_constant and not other.is_constant:
                norm *= self.ctx.ring_dim_sqrt
            return PolyNorm(self.ctx, norm, self.is_constant and other.is_constant)
        return PolyNorm(self.ctx, self.norm * Decimal(other), self.is_constant)


@dataclass(frozen=True)
class PolyMatrixNorm:
    nrow: int
    ncol: int
    poly_norm: PolyNorm
    zero_rows: int | None = None

    @staticmethod
    def new(ctx, nrow, ncol, norm, zero_rows=None) -> "PolyMatrixNorm":
        return PolyMatrixNorm(nrow, ncol, PolyNorm(ctx, Decimal(norm)), zero_rows)

    @staticmethod
    def sample_gauss(ctx, nrow, ncol, sigma) -> "PolyMatrixNorm":
        return PolyMatrixNorm(nrow, ncol, PolyNorm.sample_gauss(ctx, sigma))

    @staticmethod
    def gadget_decomposed(ctx, ncol) -> "PolyMatrixNorm":
        """Norm of a G^{-1}-decomposed matrix: entries < base (d=1)."""
        return PolyMatrixNorm(ctx.m_g, ncol, PolyNorm(ctx, ctx.base - 1))

    @staticmethod
    def gadget_decomposed_with_secret_size(ctx, secret_size, ncol) -> "PolyMatrixNorm":
        return PolyMatrixNorm(secret_size * ctx.log_base_q, ncol, PolyNorm(ctx, ctx.base - 1))

    @property
    def ctx(self):
        return self.poly_norm.ctx

    @property
    def ncol_sqrt(self) -> Decimal:
        return Decimal(self.ncol).sqrt()

    def split_rows(self, top: int):
        return replace(self, nrow=top), replace(self, nrow=self.nrow - top)

    def split_cols(self, left: int):
        return replace(self, ncol=left), replace(self, ncol=self.ncol - left)

    def __add__(self, other: "PolyMatrixNorm") -> "PolyMatrixNorm":
        if (self.nrow, self.ncol) != (other.nrow, other.ncol):
            raise ValueError("matrix dims must match")
        return PolyMatrixNorm(self.nrow, self.ncol, self.poly_norm + other.poly_norm)

    def __mul__(self, other):
        if isinstance(other, PolyMatrixNorm):
            if self.ncol != other.nrow:
                raise ValueError("inner dims must match")
            if other.zero_rows is not None:
                scale = Decimal(self.ncol - other.zero_rows).sqrt()
            else:
                scale = self.ncol_sqrt
            pn = (self.poly_norm * other.poly_norm) * scale
            return PolyMatrixNorm(self.nrow, other.ncol, pn)
        if isinstance(other, PolyNorm):
            return PolyMatrixNorm(self.nrow, self.ncol, self.poly_norm * other)
        return PolyMatrixNorm(
            self.nrow, self.ncol, self.poly_norm * Decimal(other), self.zero_rows
        )


def compute_preimage_norm(
    ring_dim_sqrt: Decimal, m_g: int, base: Decimal, b_nrow: int | None = None,
    sigma: float | None = None,
) -> Decimal:
    """Trapdoor preimage infinity-norm bound (constants of the MP12 sampler:
    spectral constant 1.8, 4.7, default sigma 4.578)."""
    c0 = Decimal("1.8")
    c1 = Decimal("4.7")
    sig = Decimal(str(sigma if sigma is not None else 4.578))
    term = (
        Decimal(b_nrow or 1).sqrt() * ring_dim_sqrt * Decimal(m_g).sqrt()
        + Decimal(2).sqrt() * ring_dim_sqrt
        + c1
    )
    return c0 * GAUSSIAN_TAIL_FACTOR * sig * ((base + 1) * sig) * term


@dataclass(frozen=True)
class ErrorNorm:
    """Evaluable norm wire: (plaintext bound, encoding-error matrix bound)."""

    plaintext_norm: PolyNorm
    matrix_norm: PolyMatrixNorm

    @property
    def ctx(self):
        return self.plaintext_norm.ctx

    def __add__(self, other: "ErrorNorm") -> "ErrorNorm":
        return ErrorNorm(
            self.plaintext_norm + other.plaintext_norm, self.matrix_norm + other.matrix_norm
        )

    def __sub__(self, other: "ErrorNorm") -> "ErrorNorm":
        # |A - B| <= |A| + |B|
        return self + other

    def __mul__(self, other: "ErrorNorm") -> "ErrorNorm":
        ctx = self.ctx
        g_dec = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        return ErrorNorm(
            self.plaintext_norm * other.plaintext_norm,
            self.matrix_norm * g_dec + other.matrix_norm * self.plaintext_norm,
        )

    def small_scalar_mul(self, params, scalar) -> "ErrorNorm":
        s = PolyNorm.constant(self.ctx, Decimal(max(scalar)))
        return ErrorNorm(self.plaintext_norm * s, self.matrix_norm * s)

    def large_scalar_mul(self, params, scalar) -> "ErrorNorm":
        ctx = self.ctx
        s = PolyNorm.constant(ctx, Decimal(max(scalar)))
        g_dec = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        return ErrorNorm(self.plaintext_norm * s, self.matrix_norm * g_dec)


class NormPltLWEEvaluator:
    """Error-norm model of the LWE LUT gate: e_b K_high + e_in K_low."""

    def __init__(self, ctx: SimulatorContext, e_b_sigma):
        k_high_norm = compute_preimage_norm(ctx.ring_dim_sqrt, ctx.m_g, ctx.base)
        self.k_low = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        e_b_init = PolyMatrixNorm.new(ctx, 1, ctx.m_b, Decimal(e_b_sigma) * 6)
        self.e_b_times_k_high = e_b_init * PolyMatrixNorm.new(ctx, ctx.m_b, ctx.m_g, k_high_norm)

    def public_lookup(self, params, plt, one, input_norm: ErrorNorm, gate_id, lut_id):
        matrix_norm = self.e_b_times_k_high + (input_norm.matrix_norm * self.k_low)
        plaintext_norm = PolyNorm.constant(
            input_norm.ctx, Decimal(plt.max_output_row[1].value)
        )
        return ErrorNorm(plaintext_norm, matrix_norm)


def simulate_max_error_norm(
    circuit,
    ctx: SimulatorContext,
    input_norm_bound,
    input_size: int,
    e_init_norm,
    plt_evaluator=None,
    slot_transfer_evaluator=None,
) -> list[ErrorNorm]:
    """Evaluate the circuit over ErrorNorm wires, gate by gate (the generic
    walk; `eval_error.simulate_max_error_norm_affine` gives the same bounds
    with cached sub-circuit summaries)."""
    one_error = ErrorNorm(
        PolyNorm.one(ctx), PolyMatrixNorm.new(ctx, 1, ctx.m_g, Decimal(e_init_norm))
    )
    input_error = ErrorNorm(
        PolyNorm.constant(ctx, Decimal(input_norm_bound)),
        PolyMatrixNorm.new(ctx, 1, ctx.m_g, Decimal(e_init_norm)),
    )
    return circuit.eval(
        None, one_error, [input_error] * input_size, plt_evaluator, slot_transfer_evaluator
    )
