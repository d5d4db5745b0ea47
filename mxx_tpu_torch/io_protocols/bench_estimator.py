"""DiamondIO benchmark estimation: measured per-op costs extrapolated over
the protocol phase structure (a copy of
`mxx_tpu/io_protocols/bench_estimator.py`).

Wall-clock a representative trapdoor preimage and per-gate wire ops at the
target parameters, then aggregate over (a) the injector's transition-preimage
count, (b) output projection + decoder preimages, and (c) the wrapped
circuit's grouped execution plan. The model leaves out what it does not
price: host work per circuit level and the artifact writes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bench_estimator import (
    GateCostModel,
    benchmark_gate_operation,
    estimate_circuit,
    measure_bgg_encoding_costs,
)
from ..circuit.analysis import GroupedExecutionPlan
from ..sampler import FinRingDist, TrapdoorSampler, UniformSampler


@dataclass
class DiamondIOBenchEstimate:
    obfuscate_latency_secs: float
    eval_latency_secs: float
    total_time_secs: float
    max_parallelism: int
    injector_preimage_count: int
    decoder_preimage_count: int
    artifact_bytes: int


def measure_preimage_cost(params, d: int = 2, cols: int | None = None,
                          iterations: int = 2, sigma: float = 4.578,
                          device="cuda") -> float:
    """Median wall time of one trapdoor preimage at protocol shape on
    `device` (the injector uses d=2 bases), one warm-up call first."""
    ts = TrapdoorSampler(params, sigma, seed=0, device=device)
    td, b = ts.trapdoor(params, d)
    cols = cols if cols is not None else b.ncol
    target = UniformSampler(seed=1, device=device).sample_uniform(params, d, cols, FinRingDist())
    return benchmark_gate_operation(
        iterations, lambda: ts.preimage(params, td, b, target), device
    )


def _dummy_debug(prf, dio, num_outputs: int):
    """Shape-only debug artifacts so the replay-mode circuit can be BUILT for
    estimation without running the obfuscation (valid ciphertext values are
    irrelevant to the gate structure)."""
    from ..utils.rng import Drbg
    from .prf_mask import PrfDebugArtifacts

    rng = Drbg(0)
    debug = PrfDebugArtifacts()
    bits_per_output = dio._mask_bits_per_output()
    packed = dio.payload_slots > 1
    for _ in range(num_outputs):
        debug.final_mask_cts.append(
            prf._sample_debug_prg_cts_packed(
                [1] * dio.payload_slots, bits_per_output, rng, 0.0
            )
            if packed
            else prf._sample_debug_prg_cts(1, bits_per_output, rng, 0.0)
        )
    return debug


def estimate_diamond_io(
    dio,
    builder,
    parallelism: int = 1,
    preimage_cost: float | None = None,
    gate_costs: GateCostModel | None = None,
) -> DiamondIOBenchEstimate:
    """Compose per-op costs over the DiamondIO phase structure; a cost left
    None is measured on the device of `dio` first."""
    params = dio.params
    if preimage_cost is None:
        preimage_cost = measure_preimage_cost(params, device=dio.device)
    if gate_costs is None:
        gate_costs = measure_bgg_encoding_costs(params, device=dio.device)

    # injector transition preimages: sum over levels of base * state_count
    injector = dio.injector
    injector_preimages = sum(
        injector.base * injector.state_count_at_level(level)
        for level in range(1, injector.input_count + 1)
    )
    # trapdoor keygens (one per level/state) counted at preimage cost scale
    trapdoor_count = sum(
        injector.state_count_at_level(level) for level in range(injector.input_count + 1)
    )

    num_outputs = dio._probe_num_outputs(builder)
    prf = dio._prf_pipeline()
    cfg = dio.prf_config
    unit = ([1] + [0] * (params.n - 1)) if dio.payload_slots > 1 else 1
    circuit = dio._build_wrapped_circuit(
        prf, builder, (unit, unit), num_outputs,
        None if not cfg.debug_encrypt_random_prg_wires else _dummy_debug(
            prf, dio, num_outputs
        ),
    )
    plan = GroupedExecutionPlan.from_circuit(circuit)
    circuit_est = estimate_circuit(circuit, gate_costs, parallelism)

    # PRF mask pipeline preimages: per round x branch x refreshed wire, one
    # rebase preimage + crt_depth refresh-decoder preimages
    prf_wires = (
        cfg.refresh_wire_limit
        if cfg.refresh_wire_limit is not None
        else cfg.seed_bits * prf.wires_per_ct
    )
    prf_preimages = (
        dio.input_count * dio.base * prf_wires * (1 + params.crt_depth)
    )

    projection_preimages = 1 + 1 + dio.num_input_bits  # one + k + input bits
    decoder_preimages = num_outputs
    offline_preimages = (
        injector_preimages + projection_preimages + decoder_preimages + prf_preimages
    )

    obfuscate_latency = (
        trapdoor_count * preimage_cost
        + offline_preimages * preimage_cost / max(parallelism, 1)
        + circuit_est.latency_secs  # pubkey-path eval
    )
    # online: injector chain matmuls (~1 matmul per state per level) + eval
    state_matmuls = sum(
        injector.state_count_at_level(level) for level in range(1, injector.input_count + 1)
    )
    matmul_cost = gate_costs.cost("Mul")
    eval_latency = state_matmuls * matmul_cost + circuit_est.latency_secs

    # artifact bytes at the COMPACT codec rate: ceil(crt_bits) bits per
    # coefficient per limb, not raw planes
    k_digits = params.modulus_digits
    state_cols = 2 * dio.secret_size * (k_digits + 2)
    entry_bytes = -(-params.crt_depth * params.crt_bits * params.n // 8)
    matrix_bytes = state_cols * state_cols * entry_bytes
    proj_bytes = state_cols * (dio.secret_size * k_digits) * entry_bytes
    artifact_bytes = (
        injector_preimages * matrix_bytes
        + (projection_preimages + decoder_preimages + prf_preimages) * proj_bytes
    )

    return DiamondIOBenchEstimate(
        obfuscate_latency_secs=obfuscate_latency,
        eval_latency_secs=eval_latency,
        total_time_secs=obfuscate_latency + eval_latency + circuit_est.total_time_secs,
        max_parallelism=max(plan.max_parallelism, parallelism),
        injector_preimage_count=injector_preimages,
        decoder_preimage_count=decoder_preimages,
        artifact_bytes=artifact_bytes,
    )
