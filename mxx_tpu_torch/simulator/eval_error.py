"""Affine error-norm evaluation engine with cached sub-circuit summaries (a
copy of `mxx_tpu/simulator/eval_error.py`).

For large circuits, evaluating every gate per
sub-circuit call is wasteful: within a fixed input-plaintext-norm profile the
matrix-norm propagation is AFFINE in the input matrix norms, so each
sub-circuit is summarized once as

    out_matrix = sum_i in_matrix_i * M_i + C

(with M_i composed right-multipliers and C a constant norm), cached per
(sub-circuit, input profile), and each call instantiates the summary in O(1)
gate work. LUT gates route through affine forms of the NormPlt* evaluators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal

from ..circuit.gate import (
    ADD,
    INPUT,
    LARGE_SCALAR_MUL,
    MUL,
    PUB_LUT,
    SMALL_SCALAR_MUL,
    SUB,
    SUB_CIRCUIT_OUTPUT,
    SUMMED_SUB_CIRCUIT_OUTPUT,
)
from .norms import ErrorNorm, PolyMatrixNorm, PolyNorm, SimulatorContext


@dataclass(frozen=True)
class AffineTerm:
    """Multiplier for one input: diagonal (scalar) part + matrix part, so the
    symbolic identity stays exact (in * 1 must not pick up sqrt factors)."""

    diag: PolyNorm | None = None
    mat: PolyMatrixNorm | None = None

    def add(self, other: "AffineTerm") -> "AffineTerm":
        diag = (
            self.diag + other.diag
            if self.diag is not None and other.diag is not None
            else (self.diag or other.diag)
        )
        mat = (
            self.mat + other.mat
            if self.mat is not None and other.mat is not None
            else (self.mat or other.mat)
        )
        return AffineTerm(diag, mat)

    def right_mul(self, mult: PolyMatrixNorm) -> "AffineTerm":
        mat = None
        if self.diag is not None:
            mat = mult * self.diag
        if self.mat is not None:
            mm = self.mat * mult
            mat = mm if mat is None else mat + mm
        return AffineTerm(None, mat)

    def scale(self, s: PolyNorm) -> "AffineTerm":
        return AffineTerm(
            self.diag * s if self.diag is not None else None,
            self.mat * s if self.mat is not None else None,
        )

    def apply(self, inp: PolyMatrixNorm) -> PolyMatrixNorm:
        acc = None
        if self.diag is not None:
            acc = inp * self.diag
        if self.mat is not None:
            t = inp * self.mat
            acc = t if acc is None else acc + t
        assert acc is not None
        return acc


@dataclass
class AffineErrorNormExpr:
    """const + sum_i input_i * terms[i] over matrix norms."""

    ctx: SimulatorContext
    const: PolyMatrixNorm | None = None
    terms: dict[int, AffineTerm] = field(default_factory=dict)

    @staticmethod
    def for_input(ctx: SimulatorContext, idx: int) -> "AffineErrorNormExpr":
        return AffineErrorNormExpr(ctx, None, {idx: AffineTerm(PolyNorm.constant(ctx, 1), None)})

    @staticmethod
    def constant(ctx, const: PolyMatrixNorm) -> "AffineErrorNormExpr":
        return AffineErrorNormExpr(ctx, const, {})

    def add_expr(self, other: "AffineErrorNormExpr") -> "AffineErrorNormExpr":
        const = (
            self.const + other.const
            if self.const is not None and other.const is not None
            else (self.const or other.const)
        )
        terms = dict(self.terms)
        for i, m in other.terms.items():
            terms[i] = terms[i].add(m) if i in terms else m
        return AffineErrorNormExpr(self.ctx, const, terms)

    def transform_matrix(self, mult: PolyMatrixNorm) -> "AffineErrorNormExpr":
        """Right-multiply the whole expression by `mult`."""
        const = self.const * mult if self.const is not None else None
        return AffineErrorNormExpr(
            self.ctx, const, {i: t.right_mul(mult) for i, t in self.terms.items()}
        )

    def scale(self, s: PolyNorm) -> "AffineErrorNormExpr":
        const = self.const * s if self.const is not None else None
        return AffineErrorNormExpr(self.ctx, const, {i: t.scale(s) for i, t in self.terms.items()})

    def instantiate(self, input_matrices: list[PolyMatrixNorm]) -> PolyMatrixNorm:
        acc = self.const
        for i, t in self.terms.items():
            term = t.apply(input_matrices[i])
            acc = term if acc is None else acc + term
        assert acc is not None, "empty affine expression"
        return acc


@dataclass
class ErrorNormSummaryExpr:
    plaintext_norm: PolyNorm
    matrix_expr: AffineErrorNormExpr


class AffineCircuitEvaluator:
    """Evaluates a circuit over ErrorNormSummaryExpr wires; sub-circuits are
    summarized once per (circuit identity, plaintext profile, bindings)."""

    def __init__(self, ctx: SimulatorContext, plt_evaluator=None):
        self.ctx = ctx
        self.plt = plt_evaluator
        self._summary_cache: dict = {}

    # --------------------------------------------------------- gate algebra

    def _g_dec(self) -> PolyMatrixNorm:
        return PolyMatrixNorm.gadget_decomposed(self.ctx, self.ctx.m_g)

    def _apply_gate(self, circuit, g, ins, param_bindings):
        ctx = self.ctx
        if g.kind in (ADD, SUB):
            return ErrorNormSummaryExpr(
                ins[0].plaintext_norm + ins[1].plaintext_norm,
                ins[0].matrix_expr.add_expr(ins[1].matrix_expr),
            )
        if g.kind == MUL:
            return ErrorNormSummaryExpr(
                ins[0].plaintext_norm * ins[1].plaintext_norm,
                ins[0]
                .matrix_expr.transform_matrix(self._g_dec())
                .add_expr(ins[1].matrix_expr.scale(ins[0].plaintext_norm)),
            )
        if g.kind == SMALL_SCALAR_MUL:
            payload = circuit._resolve_payload(g.payload, param_bindings)
            s = PolyNorm.constant(ctx, Decimal(max(payload)))
            return ErrorNormSummaryExpr(
                ins[0].plaintext_norm * s, ins[0].matrix_expr.scale(s)
            )
        if g.kind == LARGE_SCALAR_MUL:
            payload = circuit._resolve_payload(g.payload, param_bindings)
            s = PolyNorm.constant(ctx, Decimal(int(max(payload))))
            return ErrorNormSummaryExpr(
                ins[0].plaintext_norm * s,
                ins[0].matrix_expr.transform_matrix(self._g_dec()),
            )
        if g.kind == PUB_LUT:
            assert self.plt is not None, "LUT gate needs an affine plt evaluator"
            return self.plt.public_lookup_affine(ins[0], circuit.luts[g.payload])
        raise NotImplementedError(f"affine engine: gate kind {g.kind}")

    # -------------------------------------------------------------- engine

    def _profile_key(self, inputs: list[ErrorNormSummaryExpr], bindings):
        return (
            tuple(str(i.plaintext_norm.norm) for i in inputs),
            tuple(str(b) for b in bindings),
        )

    def summarize(self, circuit, one: ErrorNormSummaryExpr,
                  inputs: list[ErrorNormSummaryExpr], param_bindings=()):
        wires = {0: one}
        for i, v in enumerate(inputs):
            wires[i + 1] = v
        for g in circuit.gates:
            if g.kind == INPUT:
                continue
            ins = [wires[i] for i in g.inputs]
            if g.kind == SUB_CIRCUIT_OUTPUT:
                call_id, out_idx = g.payload
                call = circuit.sub_circuit_calls[call_id]
                outs = self._summarized_call(
                    circuit.sub_circuits[call.sub_circuit_id], one, ins, call.param_bindings
                )
                wires[g.gate_id] = outs[out_idx]
                continue
            if g.kind == SUMMED_SUB_CIRCUIT_OUTPUT:
                summed_id, out_idx = g.payload
                call = circuit.summed_sub_circuit_calls[summed_id]
                acc = None
                off = 0
                for set_idx, inp_set in enumerate(call.call_inputs):
                    sub_ins = ins[off : off + len(inp_set)]
                    off += len(inp_set)
                    outs = self._summarized_call(
                        circuit.sub_circuits[call.sub_circuit_id],
                        one,
                        sub_ins,
                        call.param_bindings[set_idx],
                    )
                    acc = (
                        outs
                        if acc is None
                        else [
                            ErrorNormSummaryExpr(
                                a.plaintext_norm + b.plaintext_norm,
                                a.matrix_expr.add_expr(b.matrix_expr),
                            )
                            for a, b in zip(acc, outs)
                        ]
                    )
                wires[g.gate_id] = acc[out_idx]
                continue
            wires[g.gate_id] = self._apply_gate(circuit, g, ins, param_bindings)
        return [wires[o] for o in circuit.output_ids]

    def _summarized_call(self, sub, one, call_inputs, bindings):
        """Summarize `sub` over symbolic inputs (cached per profile), then
        substitute the caller's expressions."""
        key = (id(sub), self._profile_key(call_inputs, bindings))
        if key not in self._summary_cache:
            sym_inputs = [
                ErrorNormSummaryExpr(
                    ci.plaintext_norm, AffineErrorNormExpr.for_input(self.ctx, i)
                )
                for i, ci in enumerate(call_inputs)
            ]
            sym_one = ErrorNormSummaryExpr(
                one.plaintext_norm, AffineErrorNormExpr.for_input(self.ctx, len(call_inputs))
            )
            self._summary_cache[key] = self.summarize(sub, sym_one, sym_inputs, bindings)
        summaries = self._summary_cache[key]
        # substitute: symbolic input i -> caller expression i; index
        # len(call_inputs) -> the one wire
        all_exprs = list(call_inputs) + [one]
        out = []
        for s in summaries:
            expr = (
                AffineErrorNormExpr.constant(self.ctx, s.matrix_expr.const)
                if s.matrix_expr.const is not None
                else AffineErrorNormExpr(self.ctx)
            )
            for i, t in s.matrix_expr.terms.items():
                caller = all_exprs[i].matrix_expr
                if t.diag is not None:
                    expr = expr.add_expr(caller.scale(t.diag))
                if t.mat is not None:
                    expr = expr.add_expr(caller.transform_matrix(t.mat))
            out.append(ErrorNormSummaryExpr(s.plaintext_norm, expr))
        return out


def simulate_max_error_norm_affine(
    circuit,
    ctx: SimulatorContext,
    input_norm_bound,
    input_size: int,
    e_init_norm,
    plt_evaluator=None,
) -> list[ErrorNorm]:
    """Affine-engine counterpart of `simulate_max_error_norm`: identical
    results, cached sub-circuit summaries."""
    ev = AffineCircuitEvaluator(ctx, plt_evaluator)
    base = PolyMatrixNorm.new(ctx, 1, ctx.m_g, Decimal(e_init_norm))
    one = ErrorNormSummaryExpr(
        PolyNorm.one(ctx), AffineErrorNormExpr.constant(ctx, base)
    )
    inputs = [
        ErrorNormSummaryExpr(
            PolyNorm.constant(ctx, Decimal(input_norm_bound)),
            AffineErrorNormExpr.constant(ctx, base),
        )
        for _ in range(input_size)
    ]
    outs = ev.summarize(circuit, one, inputs)
    return [
        ErrorNorm(o.plaintext_norm, o.matrix_expr.instantiate([])) for o in outs
    ]


class AffineLWEWrapper:
    """Affine form of NormPltLWEEvaluator."""

    def __init__(self, norm_lwe):
        self.inner = norm_lwe

    def public_lookup_affine(self, input_expr: ErrorNormSummaryExpr, plt):
        pt = PolyNorm.constant(
            input_expr.matrix_expr.ctx, Decimal(plt.max_output_row[1].value)
        )
        expr = input_expr.matrix_expr.transform_matrix(self.inner.k_low).add_expr(
            AffineErrorNormExpr.constant(
                input_expr.matrix_expr.ctx, self.inner.e_b_times_k_high
            )
        )
        return ErrorNormSummaryExpr(pt, expr)
