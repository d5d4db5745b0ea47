#!/usr/bin/env python3
"""Smoke run of mxx_tpu_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout. It imports no jax and nothing of the JAX
package, needs one card, and exits non-zero on any failure (no CUDA device,
no package beside it, a kernel that does not build, launch or agree):

1. the card's name and power limit (nvidia-smi), then the kernel build;
2. the four-step NTT kernels against the radix chain (whole batch) and the
   plain four-step (first 8 polys), and the round trip, at
   A: n=2^13, L=8, crt_bits 28, base_bits 14, B=512 (n1 = 64) and
   B: n=2^14, L=10, crt_bits 24, base_bits 12, B=64 (n1 = 128);
3. the main path: an MP12 trapdoor preimage at the bench shape
   (n=2^14, L=10, crt_bits 24, base_bits 12, d=1, sigma 4.578, seed 2,
   uniform 1x50 target), checked A x == U exactly, with the kernels' launch
   counters reset before the call and read after it;
4. timings (CUDA events, a warm-up, the median of a few runs): forward NTT
   at shape A (kernel and radix chain), preimage-cols/s, GSW ext-prods/s at
   n=2^13, L=8, B=64, and each kernel against its plain version at the
   largest transform of the preimage ([10, 1000, 16384]);
5. one JSON line of kernels, then the result line.
"""

import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def residues(params, lead, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q = params.tables(device).moduli.reshape((-1,) + (1,) * (len(lead) + 1))
    x = torch.randint(0, 2**31 - 1, (params.crt_depth,) + tuple(lead) + (params.n,),
                      generator=g, dtype=torch.int64, device=device)
    return x % q


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mxx_tpu_torch.ops import four_step
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # 1. build
    t0 = time.perf_counter()
    compile_s = four_step.build()
    print(f"build: four_step_ntt.cu compiled in {compile_s:.2f} s "
          f"({time.perf_counter() - t0:.2f} s with loading)", flush=True)
    for line in four_step.cuda_build.build_log(four_step.SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    # 2. kernels against the radix chain and the plain four-step
    for label, args, B in [("A", (8192, 8, 28, 14), 512), ("B", (16384, 10, 24, 12), 64)]:
        p = RingParams.new(*args)
        n1 = p.n // 128
        t = p.tables(dev)
        x = residues(p, (B,), 1, dev)
        fwd = four_step.four_step_ntt_fwd(x, p, n1)
        back = four_step.four_step_ntt_inv(fwd, p, n1)
        torch.cuda.synchronize()
        chain = ntt.ntt_fwd(x, t.psi_rev, t.moduli)
        ok_chain = torch.equal(fwd, chain)
        ok_chain_inv = torch.equal(four_step.four_step_ntt_inv(chain, p, n1),
                                   ntt.ntt_inv(chain, t.psi_inv_rev, t.n_inv, t.moduli))
        ok_plain = torch.equal(fwd[:, :8], four_step.four_step_ntt_fwd_plain(x[:, :8], p, n1))
        ok_plain_inv = torch.equal(back[:, :8],
                                   four_step.four_step_ntt_inv_plain(fwd[:, :8], p, n1))
        ok_trip = torch.equal(back, x)
        torch.cuda.synchronize()
        print(f"check {label} n={p.n} L={p.crt_depth} B={B} n1={n1}: fwd==chain {ok_chain}, "
              f"inv==chain {ok_chain_inv}, fwd==plain {ok_plain}, inv==plain {ok_plain_inv}, "
              f"inv(fwd(x))==x {ok_trip} (tolerance 0: bit-exact)", flush=True)
        if not all((ok_chain, ok_chain_inv, ok_plain, ok_plain_inv, ok_trip)):
            raise SystemExit(f"chip_smoke: kernel disagrees at shape {label}")
        del x, fwd, back, chain

    # 3. the main path
    pp = RingParams.new(16384, 10, 24, 12)
    ts = TrapdoorSampler(pp, 4.578, seed=2, device=dev)
    td, a = ts.trapdoor(pp, 1)
    target = UniformSampler(seed=3, device=dev).sample_uniform(pp, 1, 50, FinRingDist())
    torch.cuda.synchronize()
    four_step.launches.update(fwd=0, inv=0)
    x = ts.preimage(pp, td, a, target)
    torch.cuda.synchronize()
    counts = dict(four_step.launches)
    k = pp.modulus_digits
    shape_ok = x.shape == (k + 2, 50) and x.data.shape == (10, k + 2, 50, 16384)
    q = pp.tables(dev).moduli.view(-1, 1, 1, 1)
    range_ok = bool(((x.data >= 0) & (x.data < q)).all())
    exact = (a @ x) == target
    print(f"preimage n=16384 L=10 d=1 cols=50: x {tuple(x.data.shape)}, residues in range "
          f"{range_ok}, A x == U {exact}; launches in the call: fwd {counts['fwd']}, "
          f"inv {counts['inv']}", flush=True)
    if not (shape_ok and range_ok and exact):
        raise SystemExit("chip_smoke: preimage check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the main path did not go through both kernels")
    del x

    # 4. timings
    def timing(metric, value, unit, extra=""):
        print(f"timing: {metric} = {value:.1f} {unit}{extra} [{card}]", flush=True)

    p = RingParams.new(8192, 8, 28, 14)
    t = p.tables(dev)
    xa = residues(p, (512,), 4, dev)
    ms_kernel = cuda_ms(lambda: four_step.four_step_ntt_fwd(xa, p, 64), 10)
    ms_chain = cuda_ms(lambda: ntt.ntt_fwd(xa, t.psi_rev, t.moduli), 5)
    timing("ntt_fwd n=8192 L=8 B=512, four-step kernel", 8 * 512 / ms_kernel * 1e3,
           "limb-NTTs/s", f" ({ms_kernel:.3f} ms)")
    timing("ntt_fwd n=8192 L=8 B=512, radix chain (plain torch)", 8 * 512 / ms_chain * 1e3,
           "limb-NTTs/s", f" ({ms_chain:.3f} ms)")
    del xa

    ms_pre = cuda_ms(lambda: ts.preimage(pp, td, a, target), 3)
    timing("preimage d=1 n=16384 L=10 cols=50", 50 / ms_pre * 1e3, "preimage-cols/s",
           f" ({ms_pre:.1f} ms per call)")

    pg = RingParams.new(8192, 8, 28, 14)
    us = UniformSampler(seed=4, device=dev)
    c_mat = us.sample_uniform(pg, 2, 2 * pg.modulus_digits, FinRingDist()).to_eval()
    cts = us.sample_uniform(pg, 2, 64, FinRingDist())
    ms_gsw = cuda_ms(lambda: c_mat @ cts.decompose(), 3)
    timing("gsw ext-prod n=8192 L=8 B=64", 64 / ms_gsw * 1e3, "ext-prods/s",
           f" ({ms_gsw:.1f} ms per call)")
    del c_mat, cts
    torch.cuda.empty_cache()

    # each kernel against its plain version at the preimage's largest transform
    tpp = pp.tables(dev)
    xm = residues(pp, (1000,), 5, dev)
    kernels = []
    cases = [
        ("four_step_ntt_fwd", "fwd",
         partial(four_step.four_step_ntt_fwd, xm, pp, 128),
         partial(four_step.four_step_ntt_fwd_plain, xm, pp, 128),
         partial(ntt.ntt_fwd, xm, tpp.psi_rev, tpp.moduli)),
        ("four_step_ntt_inv", "inv",
         partial(four_step.four_step_ntt_inv, xm, pp, 128),
         partial(four_step.four_step_ntt_inv_plain, xm, pp, 128),
         partial(ntt.ntt_inv, xm, tpp.psi_inv_rev, tpp.n_inv, tpp.moduli)),
    ]
    for name, direction, run, plain, chain in cases:
        got = run()
        err = max(int((got - plain()).abs().max()), int((got - chain()).abs().max()))
        del got
        ms = cuda_ms(run, 10)
        ms_plain = cuda_ms(plain, 2)
        ms_chain = cuda_ms(chain, 3)
        timing(f"{name} [10, 1000, 16384]", ms, "ms",
               f" kernel; plain four-step {ms_plain:.3f} ms, radix chain {ms_chain:.3f} ms, "
               f"max |kernel - plain| {err} (tolerance 0: bit-exact)")
        if err != 0:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
        kernels.append({
            "name": name, "route": "cuda", "source": "mxx_tpu_torch/csrc/four_step_ntt.cu",
            "replaces": "mxx_tpu/ops/pallas_four_step.py:135",
            "launches": counts[direction], "max_abs_err": err,
            "ms": ms, "plain_ms": ms_plain, "chain_ms": ms_chain,
        })
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
