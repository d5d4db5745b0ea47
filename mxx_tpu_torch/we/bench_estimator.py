"""Diamond WE benchmark estimation (a copy of `mxx_tpu/we/bench_estimator.py`).

enc = injector preprocess (transition trapdoors + preimages) + pubkey-path
circuit eval + output-projection preimages; dec = injector online digit
threading + encoding-path circuit eval + masked decode. The model prices no
artifact write.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bench_estimator import GateCostModel, estimate_circuit, measure_bgg_encoding_costs
from ..circuit.analysis import GroupedExecutionPlan
from ..io_protocols.bench_estimator import measure_preimage_cost


@dataclass
class DiamondWEBenchEstimate:
    enc_latency_secs: float
    dec_latency_secs: float
    injector_preimage_count: int
    max_parallelism: int


def estimate_diamond_we(
    injector,
    circuit,
    num_outputs: int = 1,
    parallelism: int = 1,
    preimage_cost: float | None = None,
    gate_costs: GateCostModel | None = None,
) -> DiamondWEBenchEstimate:
    """Compose per-op costs over the WE phases; a cost left None is measured
    on the injector's device first."""
    params = injector.params
    if preimage_cost is None:
        preimage_cost = measure_preimage_cost(
            params, d=2 * injector.secret_size, device=injector.device
        )
    if gate_costs is None:
        gate_costs = measure_bgg_encoding_costs(params, device=injector.device)

    injector_preimages = sum(
        injector.base * injector.state_count_at_level(level)
        for level in range(1, injector.input_count + 1)
    )
    trapdoor_count = sum(
        injector.state_count_at_level(level)
        for level in range(injector.input_count + 1)
    )
    est = estimate_circuit(circuit, gate_costs, parallelism)
    plan = GroupedExecutionPlan.from_circuit(circuit)
    # + per-input-bit and per-output projection preimages
    projections = circuit.num_input + 1 + num_outputs
    enc_latency = (
        (trapdoor_count + injector_preimages + projections)
        * preimage_cost / max(parallelism, 1)
        + est.latency_secs
    )
    state_matmuls = sum(
        injector.state_count_at_level(level)
        for level in range(1, injector.input_count + 1)
    )
    dec_latency = (
        state_matmuls * gate_costs.cost("Mul")
        + est.latency_secs
        + num_outputs * 2 * gate_costs.cost("Mul")  # masked decode per output
    )
    return DiamondWEBenchEstimate(
        enc_latency_secs=enc_latency,
        dec_latency_secs=dec_latency,
        injector_preimage_count=injector_preimages,
        max_parallelism=max(plan.max_parallelism, parallelism),
    )
