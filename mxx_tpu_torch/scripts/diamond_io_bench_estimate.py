"""The Diamond iO benchmark-estimation table, with per-op costs measured on
the card.

The port's counterpart of `scripts/diamond_io_bench_estimate.py`: for each
configuration row, the per-op costs (one trapdoor preimage, the BGG+
encoding gate kinds) measured once per (n, depth) by the port's
`measure_preimage_cost` and `measure_bgg_encoding_costs`, composed by
`estimate_diamond_io` over the protocol's phases into obfuscate and eval
latency, parallelism and artifact bytes. Run on the card:

    python -m mxx_tpu_torch.scripts.diamond_io_bench_estimate [--out PATH]

The CSV goes to `--out` (default `build/mxx_tpu_torch/diamond_io_estimates.csv`
in the checkout).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import torch

from ..ops import cuda_build


def and_builder(circuit, bits):
    acc = bits[0]
    for b in bits[1:]:
        acc = circuit.and_gate(acc, b)
    return [acc]


# Rows are cost-model anchors (measured per-op costs composed over the
# protocol phase structure) at shapes whose wrapped circuit fits host RAM as
# Python gate objects: the gate count grows ~quadratically with the GSW
# gadget length (~gl^2 * k^2). Production-scale latencies are in the
# security-100 parameter table, which extrapolates with a documented model
# instead of building the circuit.
CONFIGS = [
    # (input_count, batch_bits, n, depth, crt_bits, base_bits)
    (4, 2, 256, 3, 28, 14),
    (8, 2, 256, 3, 28, 14),
    (4, 2, 1024, 3, 28, 14),
]

DEFAULT_OUT = cuda_build.BUILD_DIR / "diamond_io_estimates.csv"


def prf_config():
    """The rows' PRF config: the wide p-basis hosts the nested-RNS budget at
    28-bit limbs; the packed per-R'-coeff mask channel keeps mask bits per
    output at payload_slots instead of n."""
    from ..io_protocols.prf_mask import PrfConfig

    return PrfConfig(seed_bits=5, max_unreduced_muls=2, p_moduli_bits=16, p_basis="wide",
                     nested_rns_scale=256, refresh_wire_limit=1)


def estimate_row(config, preimage_cost: float, gate_costs, device="cuda") -> dict:
    """One table row: `estimate_diamond_io` at `config` with the given costs
    (seconds per preimage, a GateCostModel), the DiamondIO built on
    `device`."""
    from ..io_protocols import DiamondIO
    from ..io_protocols.bench_estimator import estimate_diamond_io
    from ..ring.params import RingParams

    input_count, batch_bits, n, depth, crt_bits, base_bits = config
    params = RingParams.new(n, depth, crt_bits, base_bits)
    dio = DiamondIO(params, input_count, batch_bits, seed=1, prf_config=prf_config(),
                    payload_slots=4, device=device)
    est = estimate_diamond_io(dio, and_builder, parallelism=8, preimage_cost=preimage_cost,
                              gate_costs=gate_costs)
    return {
        "input_bits": input_count * batch_bits,
        "ring_dim": n,
        "crt_depth": depth,
        "crt_bits": crt_bits,
        "base_bits": base_bits,
        "obfuscate_latency_secs": round(est.obfuscate_latency_secs, 3),
        "eval_latency_secs": round(est.eval_latency_secs, 3),
        "total_time_secs": round(est.total_time_secs, 3),
        "max_parallelism": est.max_parallelism,
        "injector_preimages": est.injector_preimage_count,
        "artifact_bytes": est.artifact_bytes,
    }


def main(argv=None) -> None:
    from ..bench_estimator import measure_bgg_encoding_costs
    from ..io_protocols.bench_estimator import measure_preimage_cost
    from ..ring.params import RingParams
    from .security100_parameter_table import card_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device to measure the costs on")
    card = card_line()

    rows = []
    # per-op costs are measured once per (n, depth) and shared across rows
    cost_cache = {}
    for config in CONFIGS:
        _, _, n, depth, crt_bits, base_bits = config
        if (n, depth) not in cost_cache:
            params = RingParams.new(n, depth, crt_bits, base_bits)
            cost_cache[(n, depth)] = (measure_preimage_cost(params),
                                      measure_bgg_encoding_costs(params))
        preimage_cost, gate_costs = cost_cache[(n, depth)]
        print(f"  (preimage_cost={preimage_cost:.3f}s, gate costs {gate_costs.costs}) [{card}]",
              flush=True)
        rows.append(estimate_row(config, preimage_cost, gate_costs))
        print(rows[-1], flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w", newline="") as f:
        f.write(f"# per-op costs measured on the card ({card}) by "
                "mxx_tpu_torch/scripts/diamond_io_bench_estimate.py\n")
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
