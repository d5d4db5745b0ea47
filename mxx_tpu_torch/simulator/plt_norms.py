"""Error-norm models for the GGH15 and WEE25-commit LUT evaluators (a copy
of `mxx_tpu/simulator/plt_norms.py`).

Pure norm arithmetic: they need none of the GGH15 or commit lookup code.
`NormPltLWEEvaluator` lives in `norms.py`; together they cover the three
lookup flavors.
"""

from __future__ import annotations

import math
from decimal import Decimal

from .norms import (
    GAUSSIAN_TAIL_FACTOR,
    ErrorNorm,
    PolyMatrixNorm,
    PolyNorm,
    SimulatorContext,
    compute_preimage_norm,
)


class NormPltGGH15Evaluator:
    """Norm model of the GGH15 chain lookup:
    out = const_term + input_plaintext * input_plaintext_multiplier
          + e_input * e_input_multiplier."""

    def __init__(self, ctx: SimulatorContext, e_b_sigma, e_mat_sigma, secret_sigma=None):
        gb = GAUSSIAN_TAIL_FACTOR
        pre = compute_preimage_norm(ctx.ring_dim_sqrt, ctx.m_g, ctx.base)
        e_b_init = PolyMatrixNorm.new(ctx, 1, ctx.m_b, Decimal(e_b_sigma) * gb)
        s_vec = PolyMatrixNorm.new(
            ctx, 1, ctx.secret_size, Decimal(secret_sigma) if secret_sigma else Decimal(1)
        )
        e_mat = Decimal(e_mat_sigma) * gb

        def stage_total(cols):
            from_eb = e_b_init * PolyMatrixNorm.new(ctx, ctx.m_b, cols, pre)
            from_s = s_vec * PolyMatrixNorm.new(ctx, ctx.secret_size, cols, e_mat)
            return from_eb + from_s

        gate1_total = stage_total(ctx.m_b)
        gate2_identity = stage_total(ctx.m_g)
        gate2_gy = stage_total(ctx.m_g)
        gate2_v = stage_total(ctx.m_g)
        gate2_vx = stage_total(ctx.m_g)

        g_dec = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        v_idx = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        preimage_lut = PolyMatrixNorm.new(ctx, ctx.m_b, ctx.m_g, pre)

        const = gate2_identity + (gate2_gy * g_dec) + (gate2_v * v_idx)
        const = const + gate1_total * preimage_lut
        self.const_term = const
        self.input_plaintext_multiplier = gate2_vx * v_idx
        self.e_input_multiplier = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g) * v_idx

    def public_lookup(self, params, plt, one, input_norm: ErrorNorm, gate_id, lut_id):
        pt = PolyNorm.constant(input_norm.ctx, Decimal(plt.max_output_row[1].value))
        plaintext_term = self.input_plaintext_multiplier * input_norm.plaintext_norm
        matrix_norm = (
            self.const_term
            + plaintext_term
            + input_norm.matrix_norm * self.e_input_multiplier
        )
        return ErrorNorm(pt, matrix_norm)


class NormPltCommitEvaluator:
    """Norm model of the WEE25-commit lookup: the
    opening chain contributes one preimage-norm product per tree level over
    the padded table width."""

    def __init__(self, ctx: SimulatorContext, error_sigma, tree_base: int, lut_vector_len: int):
        gb = GAUSSIAN_TAIL_FACTOR
        pre = compute_preimage_norm(ctx.ring_dim_sqrt, ctx.m_g, ctx.base)
        padded = tree_base
        while padded < max(lut_vector_len, 1):
            padded *= tree_base
        depth = max(1, round(math.log(padded, tree_base)))
        # opening z composes depth levels of z' * G^{-1}(V) + z_child
        level = PolyMatrixNorm.new(ctx, ctx.m_b, ctx.m_g, pre)
        g_dec = PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_g)
        acc = level
        for _ in range(depth - 1):
            acc = acc * PolyMatrixNorm.gadget_decomposed(ctx, ctx.m_b)
            acc = PolyMatrixNorm(ctx.m_b, ctx.m_g, acc.poly_norm) + level
        e_b = PolyMatrixNorm.new(ctx, 1, ctx.m_b, Decimal(error_sigma) * gb)
        self.lut_term = e_b * acc
        self.e_input_multiplier = g_dec

    def public_lookup(self, params, plt, one, input_norm: ErrorNorm, gate_id, lut_id):
        pt = PolyNorm.constant(input_norm.ctx, Decimal(plt.max_output_row[1].value))
        matrix_norm = self.lut_term + input_norm.matrix_norm * self.e_input_multiplier
        return ErrorNorm(pt, matrix_norm)
