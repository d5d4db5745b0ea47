"""Symbolic norm algebra for error-growth simulation.

A copy of the parts of `mxx_tpu/simulator/norms.py` that the Diamond input
injector's simulation needs (`input_injector/simulation.py`): norms are
high-precision decimals; `PolyNorm` multiplication picks up a sqrt(n) factor
unless one side is a constant polynomial, and matrix products scale by
sqrt(inner-dim). What the simulation does not call (`bits_ceil`, the circuit
error norms `ErrorNorm`, the LUT norm evaluators, `simulate_max_error_norm`)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal, getcontext

getcontext().prec = 80

GAUSSIAN_TAIL_FACTOR = Decimal("6.5")


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



@dataclass(frozen=True)
class PolyNorm:
    ctx: SimulatorContext
    norm: Decimal
    is_constant: bool = False

    @staticmethod
    def sample_gauss(ctx, sigma) -> "PolyNorm":
        return PolyNorm(ctx, Decimal(sigma) * GAUSSIAN_TAIL_FACTOR, False)

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

    @property
    def ctx(self):
        return self.poly_norm.ctx

    @property
    def ncol_sqrt(self) -> Decimal:
        return Decimal(self.ncol).sqrt()

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
