"""AKY24 FE keygen/dec benchmark estimation + decryption error simulation
(a copy of `mxx_tpu/func_enc/bench.py`).

Measured per-op costs extrapolated over the keygen (pubkey-path circuit eval
+ functional-key trapdoor preimage) and dec (encoding-path circuit eval +
projection decode) phase structures, and the composed decryption error
budget reusing the shared PRF-protocol simulation
(io_protocols/protocol_simulation.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal

from ..bench_estimator import GateCostModel, estimate_circuit, measure_bgg_encoding_costs
from ..circuit.analysis import GroupedExecutionPlan
from ..io_protocols.bench_estimator import measure_preimage_cost


@dataclass
class Aky24KeygenBenchEstimate:
    """Keygen: A_f = eval(f) over pubkeys, then
    K_f = B^{-1}(A_f G^{-1}((q/2) e_last))."""

    circuit_latency_secs: float
    preimage_secs: float
    total_secs: float
    max_parallelism: int


@dataclass
class Aky24DecBenchEstimate:
    """Dec: c_f = eval(f) over encodings, then
    c_b K_f - c_f G^{-1}((q/2) e_last) rounded."""

    circuit_latency_secs: float
    decode_secs: float
    total_secs: float
    max_parallelism: int


def estimate_aky24_keygen(
    params, func_circuit, parallelism: int = 1,
    preimage_cost: float | None = None,
    gate_costs: GateCostModel | None = None,
    secret_size: int = 2,
    device="cuda",
) -> Aky24KeygenBenchEstimate:
    """Compose per-op costs over keygen; a cost left None is measured on
    `device` first."""
    if preimage_cost is None:
        preimage_cost = measure_preimage_cost(params, d=secret_size, cols=1, device=device)
    if gate_costs is None:
        gate_costs = measure_bgg_encoding_costs(params, device=device)
    est = estimate_circuit(func_circuit, gate_costs, parallelism)
    plan = GroupedExecutionPlan.from_circuit(func_circuit)
    return Aky24KeygenBenchEstimate(
        circuit_latency_secs=est.latency_secs,
        preimage_secs=preimage_cost,
        total_secs=est.latency_secs + preimage_cost,
        max_parallelism=max(plan.max_parallelism, parallelism),
    )


def estimate_aky24_dec(
    params, func_circuit, parallelism: int = 1,
    gate_costs: GateCostModel | None = None,
    device="cuda",
) -> Aky24DecBenchEstimate:
    """Compose per-op costs over dec; the gate costs are measured on
    `device` when not given."""
    if gate_costs is None:
        gate_costs = measure_bgg_encoding_costs(params, device=device)
    est = estimate_circuit(func_circuit, gate_costs, parallelism)
    plan = GroupedExecutionPlan.from_circuit(func_circuit)
    # decode: one mul_decompose (gadget-decomposed matmul ~ Mul gate) + one
    # matmul against the stored K_f column + coefficient rounding (host)
    decode_secs = 2 * gate_costs.cost("Mul")
    return Aky24DecBenchEstimate(
        circuit_latency_secs=est.latency_secs,
        decode_secs=decode_secs,
        total_secs=est.latency_secs + decode_secs,
        max_parallelism=max(plan.max_parallelism, parallelism),
    )


def simulate_aky24_dec_error(
    params,
    func_circuit,
    prf,  # PrfMaskPipeline carrying the AKY24 PRF/refresh/mask config
    *,
    error_sigma: float = 4.0,
    trapdoor_sigma: float = 4.578,
    secret_size: int = 2,
    rounds: int | None = None,
    plt_norm_factory=None,
):
    """Composed AKY24 decryption error budget: fresh Gaussian encoding
    error (no injector) into the shared PRF-protocol budget."""
    from ..io_protocols.protocol_simulation import simulate_prf_protocol_error

    e_init = Decimal(error_sigma) * Decimal("6.5")
    return simulate_prf_protocol_error(
        params, prf, func_circuit,
        input_error_norm=e_init,
        state_error_norm=e_init,
        error_sigma=error_sigma,
        trapdoor_sigma=trapdoor_sigma,
        secret_size=secret_size,
        rounds=rounds,
        plt_norm_factory=plt_norm_factory,
    )


def max_safe_aky24_prf_mask_output_coeff_bits(
    params, func_circuit, make_prf, max_bits: int, **kwargs
):
    """Largest safe PRF mask width for AKY24 dec; each candidate re-runs the
    composed simulation."""
    from ..io_protocols.protocol_simulation import (
        max_safe_prf_mask_output_coeff_bits,
    )

    e_init = Decimal(kwargs.pop("error_sigma", 4.0))
    sigma = float(e_init)
    return max_safe_prf_mask_output_coeff_bits(
        params, make_prf, func_circuit, max_bits,
        input_error_norm=e_init * Decimal("6.5"),
        error_sigma=sigma,
        **kwargs,
    )
