"""Diamond input-insertion error-growth simulation (a copy of
`mxx_tpu/input_injector/simulation.py`): propagates the initial p_epsilon
Gaussian error and the per-level transition target errors through the state
machine, tracking the secret-selector factors per branch, and exposes the
generic output-projection preimage bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal

from ..simulator import PolyMatrixNorm, SimulatorContext, compute_preimage_norm
from .diamond import DIAMOND_SECRET_SIZE, DiamondInjector


@dataclass
class DiamondInputErrorSimulation:
    state_errors: list[PolyMatrixNorm]
    secret_state_factors: list[PolyMatrixNorm]
    output_preimage: PolyMatrixNorm


def simulate_output_error_bounds(injector: DiamondInjector) -> DiamondInputErrorSimulation:
    params = injector.params
    ctx = SimulatorContext(
        ring_dim_sqrt=Decimal(params.n).sqrt(),
        base=Decimal(1 << params.base_bits),
        secret_size=DIAMOND_SECRET_SIZE,
        log_base_q=params.modulus_digits,
        log_base_q_small=params.modulus_digits,
    )
    state_rows = injector.state_row_size
    state_cols = injector.state_col_size()
    gadget_cols = DIAMOND_SECRET_SIZE * params.modulus_digits
    sigma = Decimal(injector.error_sigma if injector.error_sigma > 0 else 0)

    initial_state_error = PolyMatrixNorm.sample_gauss(ctx, 1, state_cols, sigma)
    preimage_norm = compute_preimage_norm(
        ctx.ring_dim_sqrt, ctx.m_g, ctx.base, b_nrow=state_rows // DIAMOND_SECRET_SIZE
    )
    transition_preimage = PolyMatrixNorm.new(ctx, state_cols, state_cols, preimage_norm)
    output_preimage = PolyMatrixNorm.new(ctx, state_cols, gadget_cols, preimage_norm)
    transition_target_error = PolyMatrixNorm.sample_gauss(ctx, state_rows, state_cols, sigma)
    regular_selector = PolyMatrixNorm.new(ctx, state_rows, state_rows, 1)
    base_selector = PolyMatrixNorm.new(ctx, state_rows, state_rows, 1)
    special_selector = PolyMatrixNorm.new(
        ctx, state_rows, state_rows, 1, zero_rows=DIAMOND_SECRET_SIZE
    )

    secret_state_factors = [PolyMatrixNorm.new(ctx, 1, state_rows, 1)]
    state_errors = [initial_state_error]
    for _level in range(1, injector.input_count + 1):
        next_factors = [
            f * (base_selector if i == 0 else regular_selector)
            for i, f in enumerate(secret_state_factors)
        ]
        next_errors = [
            e * transition_preimage + f * transition_target_error
            for f, e in zip(secret_state_factors, state_errors)
        ]
        for _ in range(injector.batch_bits):
            next_factors.append(secret_state_factors[0] * special_selector)
            next_errors.append(
                state_errors[0] * transition_preimage
                + secret_state_factors[0] * transition_target_error
            )
        secret_state_factors = next_factors
        state_errors = next_errors

    return DiamondInputErrorSimulation(state_errors, secret_state_factors, output_preimage)
