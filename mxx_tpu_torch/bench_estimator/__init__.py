from .estimator import (  # noqa: F401
    CircuitBenchSummary,
    GateCostModel,
    benchmark_gate_operation,
    estimate_circuit,
    measure_bgg_encoding_costs,
    measure_bgg_poly_encoding_costs,
    measure_naive_vec_costs,
    measure_poly_costs,
)
