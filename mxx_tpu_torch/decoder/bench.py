"""Masked-decoder benchmark scaling (a copy of `mxx_tpu/decoder/bench.py`).

Measures the per-output masked-decode cost (projection matmul + G^{-1} fold +
coefficient extraction) at the target parameters and extrapolates over output
counts, so protocol estimators can price wide-output decoders without running
them.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bench_estimator import benchmark_gate_operation
from ..matrix import PolyMatrix
from ..sampler import FinRingDist, UniformSampler


@dataclass
class DecoderBenchEstimate:
    per_output_secs: float
    outputs: list
    latency_secs: list  # per outputs[i], with the given parallelism


def measure_masked_decode_cost(params, secret_size: int = 1,
                               iterations: int = 3, device="cuda") -> float:
    """Median wall time of ONE masked decode on `device`: proj - c_sd @
    G^{-1}(e_0) and the read of its first coefficient to the host, which is
    part of the decode and lies inside the timed window."""
    us = UniformSampler(seed=7, device=device)
    d = secret_size
    m_g = d * params.modulus_digits
    sel = PolyMatrix.identity(params, d, device=device).slice_columns(0, 1)
    c_sd = us.sample_uniform(params, 1, m_g, FinRingDist())
    proj = us.sample_uniform(params, 1, sel.ncol, FinRingDist())

    def op():
        noisy = proj - c_sd.mul_decompose(sel)
        return noisy.entry(0, 0).coeffs()[0]

    return benchmark_gate_operation(iterations, op, device)


def estimate_decoder_scaling(params, output_counts: list, secret_size: int = 1,
                             parallelism: int = 1,
                             per_output_cost: float | None = None,
                             device="cuda") -> DecoderBenchEstimate:
    """Extrapolate masked-decode latency over output counts; the per-output
    cost is measured on `device` when not given."""
    if per_output_cost is None:
        per_output_cost = measure_masked_decode_cost(params, secret_size, device=device)
    return DecoderBenchEstimate(
        per_output_secs=per_output_cost,
        outputs=list(output_counts),
        latency_secs=[
            n * per_output_cost / max(parallelism, 1) for n in output_counts
        ],
    )
