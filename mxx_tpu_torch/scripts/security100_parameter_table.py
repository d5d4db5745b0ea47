"""The production parameter table at the security-100 grid, with preimage
anchors measured on the card.

The port's counterpart of `scripts/security100_parameter_table.py`, with the
same grid, fit, composition and columns:

1. **Composed error budget.** The circuit phases (PRG round edge, mask
   decrypt) are too large to norm-walk at production shape, so their
   amplification bits, measured by the circuit-accurate simulation on a
   small (n, gl) grid (`FIT_GRID`), are fitted as
   a + b log2(gl) + c log2(n); the other phases (injector input
   composition, rebase and decoder preimage terms, the noise-refresh
   rounding growth, the q/4 margin) are closed-form at production shape
   (`compose_budget`).
2. **Security bits** from the core-SVP estimate at (n = 65536,
   log2 q = depth * 28, sigma 3.19).
3. **Latency floor** from the preimage throughput measured on the card at
   n = 8192 and 16384 (depth 53, d = 1, 8 columns), power-law extrapolated
   x4 in n: obfuscate_floor = total preimage work / parallelism.

Run on the card:

    python -m mxx_tpu_torch.scripts.security100_parameter_table

measures both anchors and writes the CSV to `--out` (default
`build/mxx_tpu_torch/security_bits_100_diamond_io_parameters.csv` in the
checkout). `--anchors 8192=C1,16384=C2` takes the anchors (preimage-cols/s)
from the caller instead of measuring (the module carries none); with it,
`--device cpu` runs the rest, host arithmetic, without a card.
"""

from __future__ import annotations

import argparse
import csv
import math
import subprocess
import time
from pathlib import Path

import torch

from ..ops import cuda_build

N_PROD = 65536
CRT_BITS = 28
BASE_BITS = 14
PARALLELISM = 8

CONFIGS = [(8, 10), (9, 10), (10, 10), (11, 10)]

# measured budget-fit grid (the JAX package's full circuit-accurate composed
# simulation, PrfConfig(p=16 wide, muls=2), error_sigma=4,
# trapdoor_sigma=4.578, d_secret=1): (n, gl, amp_prg_bits, mask_offset_bits)
FIT_GRID = [
    (256, 14, 504, 145),
    (256, 28, 516, 151),
    (256, 42, 525, 154),
    (1024, 28, 539, 159),
    (1024, 42, 548, 162),
]

# CRT depth per input count: the reference grid's selected depth for the same
# input bits (its search runs under tighter centered-residue norm accounting)
REF_DEPTHS = {8: 50, 9: 51, 10: 53, 11: 55}

# the preimage anchors: ring degrees, depth, trapdoor size and columns
ANCHOR_RINGS = (8192, 16384)
ANCHOR_DEPTH = 53
ANCHOR_D = 1
ANCHOR_COLS = 8

V_BITS = 756  # reference row value, reported for comparability
TRAPDOOR_SIGMA = 4.578
ERROR_SIGMA = 4.0

DEFAULT_OUT = cuda_build.BUILD_DIR / "security_bits_100_diamond_io_parameters.csv"


def _lstsq_fit(rows):
    """Least-squares fit bits = a + b*log2(gl) + c*log2(n)."""
    import numpy as np

    A = np.array([[1.0, math.log2(gl), math.log2(n)] for n, gl, _, _ in rows])
    out = []
    for col in (2, 3):
        y = np.array([r[col] for r in rows], dtype=float)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid = y - A @ coef
        out.append((coef, float(max(abs(resid)))))
    return out


def measure_preimage(n: int, depth: int, d: int, cols: int, device="cuda") -> dict:
    """Time the port's trapdoor preimage at RingParams.new(n, depth, 28, 14):
    one warm-up call, then two timed calls; B x == U is checked after every
    call (outside the timed span) and a mismatch raises. On a CUDA device each
    call is timed by CUDA events after `torch.cuda.synchronize()`, elsewhere
    by the host clock. Returns cols_per_s (cols over the mean of the two
    calls), call_ms, and held_bytes: the device memory the trapdoor, public
    matrix, target and cached operands hold once the warm-up is done (0 off
    a CUDA device)."""
    from ..ring.params import RingParams
    from ..sampler import FinRingDist, TrapdoorSampler, UniformSampler

    device = torch.device(device)
    cuda = device.type == "cuda"
    start_bytes = torch.cuda.memory_allocated(device) if cuda else 0
    params = RingParams.new(n, depth, CRT_BITS, BASE_BITS)
    ts = TrapdoorSampler(params, TRAPDOOR_SIGMA, seed=0, device=device)
    td, b = ts.trapdoor(params, d)
    tgt = UniformSampler(seed=1, device=device).sample_uniform(params, d, cols, FinRingDist())

    def checked_call() -> float:
        if cuda:
            torch.cuda.synchronize(device)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            x = ts.preimage(params, td, b, tgt)
            end.record()
            torch.cuda.synchronize(device)
            ms = begin.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            x = ts.preimage(params, td, b, tgt)
            ms = (time.perf_counter() - t0) * 1e3
        if not (b @ x) == tgt:
            raise RuntimeError(f"preimage at n={n} L={depth} d={d} cols={cols}: B x != U")
        return ms

    checked_call()
    held = torch.cuda.memory_allocated(device) - start_bytes if cuda else 0
    call_ms = [checked_call() for _ in range(2)]
    return {"cols_per_s": cols / (sum(call_ms) / len(call_ms) / 1e3), "call_ms": call_ms,
            "held_bytes": held}


def measure_preimage_cols_per_s(n: int, depth: int, d: int, cols: int, device="cuda") -> float:
    """Preimage columns per second at (n, depth, d, cols) (`measure_preimage`)."""
    return measure_preimage(n, depth, d, cols, device)["cols_per_s"]


def compose_budget(depth: int, input_count: int, batch_bits: int,
                   prg_coef, mask_coef, v_bits: int, device="cuda"):
    """Closed-form phase composition at production shape using the fitted
    circuit-phase amplifications. Returns (margin_bits, phases dict). The
    injector is built on `device` for its geometry and simulated bounds
    only."""
    from decimal import Decimal

    from ..input_injector import DiamondInjector
    from ..io_protocols.diamond_io import DIAMOND_SECRET_SIZE
    from ..io_protocols.protocol_simulation import diamond_compose_input_error
    from ..noise_refresh.refresh import (
        pre_rounding_bound_holds,
        simulate_noise_refresh_error_growth,
    )
    from ..ring.params import RingParams
    from ..simulator import SimulatorContext, bits_ceil, compute_preimage_norm

    params = RingParams.new(N_PROD, depth, CRT_BITS, BASE_BITS)
    ctx = SimulatorContext.for_params(params, DIAMOND_SECRET_SIZE)
    injector = DiamondInjector(
        params, input_count, 1 << batch_bits, batch_bits, TRAPDOOR_SIGMA, ERROR_SIGMA,
        secret_size=DIAMOND_SECRET_SIZE, device=device,
    )
    e_enc, worst_state = diamond_compose_input_error(params, injector, TRAPDOOR_SIGMA)
    input_bits = bits_ceil(Decimal(e_enc))

    gl = -(-params.modulus.bit_length() // 4)  # base-16 GSW gadget length
    amp = prg_coef[0] + prg_coef[1] * math.log2(gl) + prg_coef[2] * math.log2(N_PROD)
    off = mask_coef[0] + mask_coef[1] * math.log2(gl) + mask_coef[2] * math.log2(N_PROD)

    preimage_norm = compute_preimage_norm(
        ctx.ring_dim_sqrt, ctx.m_g, Decimal(1 << BASE_BITS),
        b_nrow=DIAMOND_SECRET_SIZE, sigma=TRAPDOOR_SIGMA,
    )
    decoder_term = Decimal(worst_state) * preimage_norm * Decimal(ctx.m_b).sqrt()
    decoder_bits = bits_ceil(decoder_term)
    q_bits = params.modulus_bits

    # two representative rounds (first + steady state), like the direct sim
    seed_bits_err = input_bits
    refreshed_bits = None
    pre_round_ok = True
    for _ in range(2):
        prg_bits = int(math.ceil(seed_bits_err + amp))
        rebase = Decimal(2) ** prg_bits + decoder_term
        if not pre_rounding_bound_holds(rebase, q_bits, v_bits):
            pre_round_ok = False
        refreshed = simulate_noise_refresh_error_growth(
            ctx, rebase, v_bits, depth, 2, q_bits
        ) + decoder_term * Decimal(depth)
        refreshed_bits = bits_ceil(refreshed)
        seed_bits_err = refreshed_bits
    mask_bits = int(math.ceil(refreshed_bits + amp + off))
    fn_bits = input_bits + 30  # 1-gate function circuit + G^{-1} fold slack
    total = max(mask_bits, fn_bits, decoder_bits) + 2  # bit-level sum slack
    q4 = (params.modulus // 4).bit_length()
    margin = q4 - total
    return margin, {
        "input": input_bits, "amp": round(amp, 1), "refreshed": refreshed_bits,
        "mask": mask_bits, "decoder": decoder_bits, "total": total,
        "q4": q4, "pre_round_ok": pre_round_ok, "gl": gl,
    }


def extrapolated_cols_per_s(anchors: dict) -> float:
    """Preimage-cols/s at N_PROD from the two anchors by the power law
    cols/s ~ n^-alpha (alpha from the anchors' ratio, at least 0)."""
    alpha = math.log2(max(anchors[8192] / anchors[16384], 1.0))
    return anchors[16384] / (4 ** alpha)


def table_rows(anchors: dict, device="cuda") -> list[dict]:
    """The table's rows, one per CONFIGS entry, from the preimage anchors
    {8192: cols/s, 16384: cols/s} at depth 53 (the injectors of
    `compose_budget` are built on `device`)."""
    from ..input_injector import DiamondInjector
    from ..io_protocols.diamond_io import DIAMOND_SECRET_SIZE
    from ..ring.params import RingParams
    from ..simulator.lattice_estimator import core_svp_security_bits, estimator_cli_available

    (prg_coef, _), (mask_coef, _) = _lstsq_fit(FIT_GRID)
    cols_per_s_prod = extrapolated_cols_per_s(anchors)

    rows = []
    for input_count, batch_bits in CONFIGS:
        # The worst-case composed budget cannot certify the real-mode steady
        # state at any (depth, v): the refreshed error is the rounding
        # granularity q/2^v, and the next PRG round amplifies it by `amp`
        # bits, so pre-rounding demands amp < -1. The replay-mode budget
        # (validated at n=256) is the one with meaningful margins.
        depth = REF_DEPTHS[input_count]
        margin, phases = compose_budget(
            depth, input_count, batch_bits, prg_coef, mask_coef, V_BITS, device
        )

        # replay-mode margin: mask cts are fresh encryptions, no PRG round
        # evolution; mask = fresh-ct bits + fitted decrypt offset
        fresh_bits = math.ceil(math.log2(6.5 * ERROR_SIGMA) + 0.5 * math.log2(N_PROD))
        off = mask_coef[0] + mask_coef[1] * math.log2(phases["gl"]) \
            + mask_coef[2] * math.log2(N_PROD)
        replay_mask = int(math.ceil(fresh_bits + off))
        replay_total = max(replay_mask, phases["input"] + 30, phases["decoder"]) + 2
        replay_margin = phases["q4"] - replay_total

        log2q = depth * CRT_BITS
        sec = core_svp_security_bits(N_PROD, log2q, 3.19)
        cli = estimator_cli_available()

        params = RingParams.new(N_PROD, depth, CRT_BITS, BASE_BITS)
        k_digits = params.modulus_digits
        base = 1 << batch_bits
        injector = DiamondInjector(
            params, input_count, base, batch_bits, TRAPDOOR_SIGMA, ERROR_SIGMA,
            secret_size=DIAMOND_SECRET_SIZE, device=device,
        )
        injector_preimages = sum(
            base * injector.state_count_at_level(level)
            for level in range(1, input_count + 1)
        )
        state_cols = 2 * DIAMOND_SECRET_SIZE * (k_digits + 2)
        per_preimage_secs = (state_cols * 2) / cols_per_s_prod
        obfuscate_floor = injector_preimages * per_preimage_secs / PARALLELISM
        obfuscate_critical = (input_count + 2) * per_preimage_secs

        entry_bytes = -(-depth * CRT_BITS * N_PROD // 8)
        artifact_bytes = injector_preimages * state_cols * state_cols * entry_bytes

        rows.append({
            "input_bits": input_count * batch_bits,
            "input_count": input_count,
            "batch_bits": batch_bits,
            "ring_dim": N_PROD,
            "crt_depth": depth,
            "crt_bits": CRT_BITS,
            "base_bits": BASE_BITS,
            "gadget_len": phases["gl"],
            "security_bits": round(sec, 1),
            "security_source": "lattice-estimator-cli" if cli else "core-SVP fallback",
            "replay_budget_margin_bits": replay_margin,
            "replay_total_error_bits": replay_total,
            "worstcase_input_error_bits": phases["input"],
            "worstcase_prg_amp_bits": float(phases["amp"]),
            "worstcase_mask_error_bits": phases["mask"],
            "worstcase_margin_bits": margin,
            "steady_state_pre_rounding_feasible_worstcase": False,
            "injector_preimages": injector_preimages,
            "measured_preimage_cols_per_s_n16384_L53": round(anchors[16384], 2),
            "extrapolated_cols_per_s_n65536": round(cols_per_s_prod, 2),
            "obfuscate_floor_secs_par8": round(obfuscate_floor, 1),
            "obfuscate_critical_path_secs": round(obfuscate_critical, 1),
            "est_artifact_bytes": artifact_bytes,
        })
    return rows


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_csv(rows: list[dict], anchors_note: str, out: Path) -> None:
    """The table with its methodology header; `anchors_note` says where the
    anchors came from."""
    (_, prg_resid), (_, mask_resid) = _lstsq_fit(FIT_GRID)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        f.write("# methodology: see mxx_tpu_torch/scripts/security100_parameter_table.py "
                "module doc (fitted circuit-phase bits + closed-form composition + "
                "preimage anchors of the port)\n")
        f.write(f"# anchors: {anchors_note}\n")
        f.write(f"# fit grid (n, gl, amp_prg_bits, mask_offset_bits): {FIT_GRID}\n")
        f.write(f"# fit residuals: amp {prg_resid:.1f} bits, off {mask_resid:.1f} bits\n")
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def parse_anchors(text: str) -> dict:
    """'8192=C1,16384=C2' -> {8192: C1, 16384: C2}; both rings required."""
    anchors = {}
    for item in text.split(","):
        n, _, value = item.partition("=")
        anchors[int(n)] = float(value)
    if set(anchors) != set(ANCHOR_RINGS):
        raise ValueError(f"--anchors needs exactly the rings {ANCHOR_RINGS}, got {sorted(anchors)}")
    return anchors


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--anchors", help="8192=C1,16384=C2 preimage-cols/s; measured if absent")
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    parser.add_argument("--device", default="cuda",
                        help="device of the measurement and the injectors' geometry")
    args = parser.parse_args(argv)

    (prg_coef, prg_resid), (mask_coef, mask_resid) = _lstsq_fit(FIT_GRID)
    print(f"fit: amp = {prg_coef[0]:.1f} + {prg_coef[1]:.1f} log2(gl) + "
          f"{prg_coef[2]:.1f} log2(n)  (max resid {prg_resid:.1f} bits)")
    print(f"fit: off = {mask_coef[0]:.1f} + {mask_coef[1]:.1f} log2(gl) + "
          f"{mask_coef[2]:.1f} log2(n)  (max resid {mask_resid:.1f} bits)")

    if args.anchors:
        anchors = parse_anchors(args.anchors)
        note = f"given by the caller (--anchors {args.anchors})"
    else:
        if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
            raise SystemExit("the anchors are measured on a CUDA device: pass --anchors")
        card = card_line()
        anchors = {}
        for n in ANCHOR_RINGS:
            anchors[n] = measure_preimage_cols_per_s(n, ANCHOR_DEPTH, ANCHOR_D, ANCHOR_COLS,
                                                     args.device)
            print(f"anchor n={n}: {anchors[n]:.2f} cols/s [{card}]", flush=True)
        note = (f"measured on the card ({card}): d={ANCHOR_D}, {ANCHOR_COLS} cols, "
                f"L={ANCHOR_DEPTH}, " + ", ".join(f"n={n} {c!r} cols/s" for n, c in anchors.items()))
    rows = table_rows(anchors, args.device)
    for row in rows:
        print(row, flush=True)
    write_csv(rows, note, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
