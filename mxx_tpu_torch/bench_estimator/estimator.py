"""Predictive performance model: measured per-gate-kind costs aggregated over
the grouped execution plan (a copy of `mxx_tpu/bench_estimator/estimator.py`
with its own timing closure).

`benchmark_gate_operation` wall-clocks a representative wire op; the summary
walks the GroupedExecutionPlan with latency = critical path through levels
(each level costs its most expensive group op, groups within a level run in
parallel up to `parallelism`), total_time = sum of all op costs, and
max_parallelism = widest level.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..circuit.analysis import GroupedExecutionPlan
from ..circuit.gate import ADD, LARGE_SCALAR_MUL, MUL, PUB_LUT, SMALL_SCALAR_MUL, SUB


def _synchronizer(device):
    """A call that waits for `device`: `torch.cuda.synchronize` on a CUDA
    device; nothing on the CPU, where an op has finished when it returns."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def benchmark_gate_operation(iterations: int, op, device="cuda") -> float:
    """Median wall time (seconds) of `op` over `iterations` runs, after one
    warm-up run. The device is synchronized before the host clock starts and
    after `op` returns, so each time covers the op's device work and its host
    work both: the wall time a protocol pays per op."""
    sync = _synchronizer(device)
    op()  # warm-up (kernel builds, table caches)
    times = []
    for _ in range(iterations):
        sync()
        t0 = time.perf_counter()
        op()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@dataclass
class GateCostModel:
    """Seconds per gate kind (unknown kinds fall back to `default_cost`)."""

    costs: dict[str, float] = field(default_factory=dict)
    default_cost: float = 0.0

    def cost(self, kind: str) -> float:
        return self.costs.get(kind, self.default_cost)


@dataclass
class CircuitBenchSummary:
    latency_secs: float  # critical path through levels
    total_time_secs: float  # sum of all op costs
    max_parallelism: int


def estimate_circuit(circuit, cost_model: GateCostModel, parallelism: int = 1
                     ) -> CircuitBenchSummary:
    plan = GroupedExecutionPlan.from_circuit(circuit)
    latency = 0.0
    total = 0.0
    for lvl in plan.levels:
        level_latency = 0.0
        for kind, gids in lvl.groups.items():
            c = cost_model.cost(kind)
            total += c * len(gids)
            # gates of one kind in a level run `parallelism`-wide
            waves = -(-len(gids) // max(parallelism, 1))
            level_latency = max(level_latency, c * waves)
        latency += level_latency
    return CircuitBenchSummary(latency, total, plan.max_parallelism)


def measure_poly_costs(params, iterations: int = 5, device="cuda") -> GateCostModel:
    """Measure representative plain-poly wire op costs on `device`."""
    from ..sampler import FinRingDist, UniformSampler

    us = UniformSampler(seed=0, device=device)
    a = us.sample_poly(params, FinRingDist()).to_eval()
    b = us.sample_poly(params, FinRingDist()).to_eval()
    costs = {
        ADD: benchmark_gate_operation(iterations, lambda: a + b, device),
        SUB: benchmark_gate_operation(iterations, lambda: a - b, device),
        MUL: benchmark_gate_operation(iterations, lambda: a * b, device),
    }
    costs[SMALL_SCALAR_MUL] = costs[MUL]
    costs[LARGE_SCALAR_MUL] = costs[MUL]
    return GateCostModel(costs, default_cost=costs[MUL])


def measure_lwe_lut_online_cost(params, d: int = 1, iterations: int = 3,
                                device="cuda") -> float:
    """Wall-clock one LWE online lookup's algebra (K_low hash derivation +
    c_b @ K_high + c_z @ K_low): the PubLut gate cost in the encoding model
    (the real lookup op instead of a Mul)."""
    from ..lookup.lwe import derive_k_low
    from ..sampler import FinRingDist, UniformSampler

    us = UniformSampler(seed=5, device=device)
    k = params.modulus_digits
    m_g, m_b = d * k, d * (k + 2)
    c_b = us.sample_uniform(params, 1, m_b, FinRingDist())
    c_z = us.sample_uniform(params, 1, m_g, FinRingDist())
    k_high = us.sample_uniform(params, m_b, m_g, FinRingDist())

    def op():
        k_low = derive_k_low(params, d, bytes(32), 0, 0, 0, device=device)
        return c_b @ k_high + c_z @ k_low

    return benchmark_gate_operation(iterations, op, device)


def measure_bgg_encoding_costs(params, d: int = 1, iterations: int = 3,
                               lut_cost: float | None = None,
                               device="cuda") -> GateCostModel:
    """Measure representative BGG-encoding wire op costs on `device` (the
    protocol-eval cost model)."""
    from ..bgg import BGGEncodingSampler, BGGPublicKeySampler
    from ..ring.poly import Poly
    from ..sampler import TernaryDist, UniformSampler

    us = UniformSampler(seed=1, device=device)
    secrets = [us.sample_poly(params, TernaryDist()) for _ in range(d)]
    pk = BGGPublicKeySampler(bytes(32), d, device).sample(params, b"bench", [True, True])
    es = BGGEncodingSampler(params, secrets, None, seed=2)
    encs = es.sample(
        params, pk, [Poly.const(params, 1, device), Poly.const(params, 0, device)]
    )
    e1, e2 = encs[1], encs[2]
    costs = {
        ADD: benchmark_gate_operation(iterations, lambda: e1 + e2, device),
        MUL: benchmark_gate_operation(iterations, lambda: e1 * e2, device),
    }
    costs[SUB] = costs[ADD]
    costs[SMALL_SCALAR_MUL] = costs[ADD]
    costs[LARGE_SCALAR_MUL] = costs[MUL]
    costs[PUB_LUT] = (
        lut_cost if lut_cost is not None
        else measure_lwe_lut_online_cost(params, d, iterations, device)
    )
    return GateCostModel(costs, default_cost=costs[MUL])


def measure_bgg_poly_encoding_costs(params, num_slots: int = 2, iterations: int = 3,
                                    lut_cost: float | None = None,
                                    device="cuda") -> GateCostModel:
    """Packed slot-wise encoding cost model: slot ops are single batched
    matmuls over the stacked rows."""
    from ..bgg import BGGPublicKeySampler
    from ..bgg.poly_encoding import BGGPolyEncodingSampler
    from ..ring.poly import Poly
    from ..sampler import TernaryDist, UniformSampler

    us = UniformSampler(seed=3, device=device)
    secrets = [us.sample_poly(params, TernaryDist())]
    pk = BGGPublicKeySampler(bytes(32), 1, device).sample(params, b"bench", [True, True])
    sampler = BGGPolyEncodingSampler(params, secrets, num_slots, None, seed=4)
    pts = [[Poly.const(params, v, device) for v in range(num_slots)]] * 2
    encs = sampler.sample(params, pk, pts)
    e1, e2 = encs[1], encs[2]
    costs = {
        ADD: benchmark_gate_operation(iterations, lambda: e1 + e2, device),
        MUL: benchmark_gate_operation(iterations, lambda: e1 * e2, device),
    }
    costs[SUB] = costs[ADD]
    costs[SMALL_SCALAR_MUL] = costs[ADD]
    costs[LARGE_SCALAR_MUL] = costs[MUL]
    costs[PUB_LUT] = (
        lut_cost if lut_cost is not None
        else num_slots * measure_lwe_lut_online_cost(params, 1, iterations, device)
    )
    return GateCostModel(costs, default_cost=costs[MUL])


def measure_naive_vec_costs(params, num_slots: int = 2, iterations: int = 3,
                            lut_cost: float | None = None,
                            device="cuda") -> GateCostModel:
    """Vector-of-scalar-wires cost model: slot ops run per slot; costs scale
    the scalar encoding model by the slot count."""
    scalar = measure_bgg_encoding_costs(params, 1, iterations, lut_cost, device)
    costs = {k: v * num_slots for k, v in scalar.costs.items()}
    return GateCostModel(costs, default_cost=scalar.default_cost * num_slots)
