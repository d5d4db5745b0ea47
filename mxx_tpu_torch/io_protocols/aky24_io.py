"""AKY24 FE-to-iO wrapper: parameter carrier + error simulation + crt-depth
search (a copy of `mxx_tpu/io_protocols/aky24_io.py`).

This is the parameter carrier used by the simulation/bench-estimation pipeline: it
shares the DiamondIO PRF / noise-refresh / decode models but replaces the
Diamond input-injection state with a fresh Gaussian encoding error. The
runnable FE underneath lives in `func_enc.Aky24FuncEnc`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal

from ..gadgets.fhe_prg.goldreich import minimum_goldreich_input_size
from ..ring.params import RingParams
from ..simulator import (
    NormPltLWEEvaluator,
    SimulatorContext,
    bits_ceil,
    simulate_max_error_norm,
)


@dataclass
class Aky24IOFuncType:
    """The Goldreich-PRF function type: its output width."""

    output_bits: int


@dataclass
class Aky24IO:
    """Parameter carrier."""

    params: RingParams
    bgg_tag: bytes
    input_size: int
    output_size: int
    seed_bits: int
    prf_batch_bits: int
    prf_mask_output_coeff_bits: int
    noise_refresh_v_bits: int
    noise_refresh_cbd_n: int
    noise_refresh_hash_key: bytes = bytes(32)
    goldreich_graph_seed: bytes = bytes(32)
    error_sigma: float = 4.0
    secret_size: int = 1

    @property
    def prf_rounds(self) -> int:
        return -(-self.input_size // self.prf_batch_bits)

    def minimum_seed_bits(self) -> int:
        """Seed size required by the Goldreich locality bound for the PRG
        outputs consumed per round."""
        per_round_outputs = (
            self.seed_bits + self.output_size * self.prf_mask_output_coeff_bits
        )
        return minimum_goldreich_input_size(per_round_outputs)


@dataclass
class Aky24IOErrorSimulation:
    """Per-phase error norms for the AKY24 iO pipeline (fresh Gaussian input
    error instead of injection)."""

    ctx: SimulatorContext
    encoding_error_bits: int = 0
    circuit_error_bits: int = 0
    decode_margin_bits: int = 0
    ok: bool = False


def simulate_aky24_io(io: Aky24IO, circuit, plt_norm=None) -> Aky24IOErrorSimulation:
    """Simulate error growth of `circuit` under fresh Gaussian encodings and
    check the decode margin against q/4."""
    params = io.params
    ctx = SimulatorContext.for_params(params, io.secret_size)
    e_init = Decimal(io.error_sigma) * Decimal("6.5")
    if plt_norm is None:
        plt_norm = NormPltLWEEvaluator(ctx, Decimal(io.error_sigma))
    outs = simulate_max_error_norm(
        circuit, ctx, Decimal(1), circuit.num_input, e_init, plt_evaluator=plt_norm
    )
    max_err = max(o.matrix_norm.poly_norm.norm for o in outs)
    q_quarter_bits = (params.modulus // 4).bit_length()
    err_bits = bits_ceil(max_err)
    return Aky24IOErrorSimulation(
        ctx,
        encoding_error_bits=bits_ceil(e_init),
        circuit_error_bits=err_bits,
        decode_margin_bits=q_quarter_bits - err_bits,
        ok=err_bits < q_quarter_bits,
    )


@dataclass
class Aky24IOBenchEstimate:
    """Obfuscate = PRF-round
    pubkey evals + rebase/refresh preimages + projections (NO injector —
    fresh Gaussian encodings); eval = selected-branch PRF encoding evals +
    function circuit + masked decode."""

    obfuscate_latency_secs: float
    eval_latency_secs: float
    prf_preimage_count: int
    max_parallelism: int


def estimate_aky24_io(
    io: Aky24IO,
    circuit,
    parallelism: int = 1,
    preimage_cost: float | None = None,
    gate_costs=None,
    device="cuda",
) -> Aky24IOBenchEstimate:
    """Compose per-op costs over the AKY24 iO phases; a cost left None is
    measured on `device` first."""
    from ..bench_estimator import estimate_circuit, measure_bgg_encoding_costs
    from ..circuit.analysis import GroupedExecutionPlan
    from .bench_estimator import measure_preimage_cost

    params = io.params
    if preimage_cost is None:
        preimage_cost = measure_preimage_cost(params, d=io.secret_size, device=device)
    if gate_costs is None:
        gate_costs = measure_bgg_encoding_costs(params, device=device)
    est = estimate_circuit(circuit, gate_costs, parallelism)
    plan = GroupedExecutionPlan.from_circuit(circuit)
    branch_count = 1 << io.prf_batch_bits
    # per round x branch x seed wire: 1 rebase + crt_depth refresh preimages
    prf_preimages = (
        io.prf_rounds * branch_count * io.seed_bits
        * (1 + params.crt_depth)
    )
    projections = io.input_size + 1 + io.output_size
    obf_latency = (
        (prf_preimages + projections) * preimage_cost / max(parallelism, 1)
        + 2 * est.latency_secs  # pubkey-path PRF + function evals
    )
    eval_latency = est.latency_secs + io.output_size * 2 * gate_costs.cost("Mul")
    return Aky24IOBenchEstimate(
        obfuscate_latency_secs=obf_latency,
        eval_latency_secs=eval_latency,
        prf_preimage_count=prf_preimages,
        max_parallelism=max(plan.max_parallelism, parallelism),
    )


def aky24_io_find_crt_depth(
    make_circuit,
    ring_dimension: int,
    crt_bits: int,
    base_bits: int,
    max_depth: int,
    io_kwargs: dict,
) -> tuple[int, RingParams] | None:
    """Smallest crt_depth whose simulated error leaves a positive decode
    margin."""
    for depth in range(1, max_depth + 1):
        params = RingParams.new(ring_dimension, depth, crt_bits, base_bits)
        io = Aky24IO(params=params, **io_kwargs)
        circuit = make_circuit(params)
        sim = simulate_aky24_io(io, circuit)
        if sim.ok:
            return depth, params
    return None
