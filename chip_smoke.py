#!/usr/bin/env python3
"""Smoke run of mxx_tpu_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout. It imports no jax and nothing of the JAX
package, needs one card, and exits non-zero on any failure (no CUDA device,
no package beside it, a kernel that does not build, launch or agree):

1. the card's name and power limit (nvidia-smi), then the kernel builds (one
   nvcc per source, started together);
2. the four-step NTT kernels (K1 forward, K2 inverse) against the radix
   chain (whole batch) and the plain four-step (first 8 polys), and the round
   trip, at
   A: n=2^13, L=8, crt_bits 28, base_bits 14, B=512 (n1 = 64),
   B: n=2^14, L=10, crt_bits 24, base_bits 12, B=64 (n1 = 128) and
   C: the same ring at B=1000, the preimage's largest transform;
3. the radix-2 kernel's path (K3): `ntt_fwd_head` and `ntt_fwd_hybrid` at
   shapes A and B, with their launch counters reset before and read after,
   then checked against their plain versions, the radix chain and K1;
4. the main path: an MP12 trapdoor preimage at the bench shape
   (n=2^14, L=10, crt_bits 24, base_bits 12, d=1, sigma 4.578, seed 2,
   uniform 1x50 target), checked A x == U exactly, with the kernels' launch
   counters reset before the call and read after it;
5. BGG+ circuit evaluation at n=2^13, L=8, crt_bits 28, base_bits 14, d=1:
   16 public and 16 secret inputs, hash-sampled public keys, encodings with
   zero error, scaled public inputs (8 SmallScalarMul, 8 LargeScalarMul),
   their inner product with the secret inputs (16 Mul, 15 Add) and 4 Sub;
   the pubkey and encoding passes each run sequentially and through
   `eval_batched`, checked batched == sequential, encoding pubkeys == pubkey
   pass, and the decode invariant c = s A - x (s G) exactly, with the
   four-step kernels' launch counters reset before and read after;
6. the debug LUT evaluators at the same ring: one level of 8 PubLut gates,
   batched == sequential, the relation c = s A - y (s G) exact (the
   sequential pass through RelationCheckingPltEvaluator);
7. the LWE public-LUT chain of scripts/realistic_scale_run.py at full width
   (n=2^13, L=8, crt_bits 28, base_bits 14, d=1, error sigma 4.0, trapdoor
   sigma 4.578, p=7, a 49-entry LUT, Mul -> PubLut -> Mul -> PubLut): the
   plaintext oracle, the offline pubkey pass, `sample_aux_matrices` and
   `wait_for_all_writes` into a temporary directory (7.4 GB of K_high; its
   free space is checked first), the online encoding pass and the
   masked-rounding decode, with the four-step kernels' launch counters reset
   before and read after; checked against the oracle, A_LT online ==
   offline, the error against the q/(2p) budget, and B K_high == target for
   every stored row; each sub-phase timed after a synchronize (the port's
   tracing spans, which synchronize when enabled);
8. Diamond witness encryption at the same ring (injector input_count 2,
   base 2, batch_bits 1, trapdoor sigma 4.578, error sigma 4.0; 2 witness
   bits, the circuit OR(w0, w1) with one instance bit): `enc` of False and
   of True, each with a fresh injector into its own temporary directory
   (about 4.2 GB of artifacts, deleted after its checks), then `dec` with
   the witness [False, True]; checked: both messages decode (margins
   printed), every final injector state of the first encryption within its
   simulated error bound and below q/4, every state and read preimage on the
   card; preprocess, trapdoor, preimage, artifact-write, output-preimage,
   online and decode times;
9. AKY24 functional encryption at the same ring (8 message bits, error
   sigma 3.0, f = x0^x1^(x2&x3)^(x4|x5)^(x6&x7)): setup, keygen, and enc and
   dec of four messages with f = 0 and f = 1; checked: each decode equals
   f(x), B K_f == A_f G^{-1}((q/2) e_last) exactly; K1 and K2 launched in
   each of phases 8 and 9 (counters reset before, read after);
10. timings (CUDA events, a warm-up, the median of a few runs): forward NTT
   at shape A (K1, K3, radix chain) and K2 there, preimage-cols/s, a profiled
   preimage, its device time split by stage, GSW ext-prods/s at n=2^13, L=8,
   B=64, each kernel against its plain version at the largest transform of
   the preimage ([10, 1000, 16384]), the two batched BGG passes, and a
   profiled batched encoding pass, its device time split by stage;
11. one JSON line of kernels (K1/K2 `launches` from the LWE LUT chain, each
   path's count beside it in `launches_by_path`; each kernel's least time
   `bound_ms`, the larger of its device-memory time and its integer floor,
   and its share `pct_of_bound`; `library_ms` null, since no PyTorch call
   computes an exact NTT mod q), then the result line.
"""

import json
import logging
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

BGG_KEY = bytes([0x13, 0x37, 0xC0, 0xDE] * 8)  # scripts/realistic_scale_run.py's key
N_BGG_INPUTS = 16
P_MOD = 7


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


def max_err(a, b) -> int:
    return int((a - b).abs().max())


# the least time of an NTT kernel: the larger of its device-memory time
# (int64 residues read once and written once, 16 bytes each, over the H100
# SXM's 3.35 TB/s) and its integer floor (each modular product of the
# butterfly algorithm with its add and subtract, ~8 32-bit instructions,
# over 64 int32 lanes x 132 SMs x 1.98 GHz = 16.7e12 instructions/s)
HBM_BYTES_PER_S = 3.35e12
INT32_PER_S = 64 * 132 * 1.98e9
INSTR_PER_PRODUCT = 8


def ntt_products(n: int, span: int, twist: bool = False) -> int:
    """Modular products per poly of log2(span) radix-2 stages, n/2 each
    (span = n: the whole transform), plus n twist products."""
    return n // 2 * (span.bit_length() - 1) + (n if twist else 0)


def ntt_bound(shape, products: int) -> dict:
    polys = math.prod(shape[:-1])
    bytes_ms = 16 * polys * shape[-1] / HBM_BYTES_PER_S * 1e3
    int_ms = polys * products * INSTR_PER_PRODUCT / INT32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, int_ms), "bound_by": "bytes" if bytes_ms >= int_ms
            else "operations", "bytes_ms": bytes_ms, "int_floor_ms": int_ms}


def build_kernels(modules) -> None:
    """One nvcc per source, all started together; ptxas lines printed."""
    from mxx_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        seconds = list(pool.map(lambda m: m.build(), modules))
    for m, s in zip(modules, seconds):
        print(f"build: {m.SOURCE} compiled in {s:.2f} s", flush=True)
        for line in cuda_build.build_log(m.SOURCE).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {m.SOURCE}: {line.strip()}", flush=True)
    print(f"build: all kernels ready in {time.perf_counter() - t0:.2f} s (with loading)",
          flush=True)


def check_four_step(dev, shapes) -> None:
    """K1 and K2 against the radix chain and the plain four-step."""
    import torch

    from mxx_tpu_torch.ops import four_step
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams

    for label, args, B in shapes:
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
            raise SystemExit(f"chip_smoke: four-step kernel disagrees at shape {label}")


def drive_radix(dev, shapes) -> tuple[dict, int]:
    """K3's path: ntt_fwd_head and ntt_fwd_hybrid at each shape, counted;
    then each result against the plain versions, the radix chain and K1."""
    import torch

    from mxx_tpu_torch.ops import four_step, hybrid_ntt
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams

    inputs = []
    for label, args, B in shapes:
        p = RingParams.new(*args)
        inputs.append((label, p, residues(p, (B,), 6, dev)))
    torch.cuda.synchronize()
    hybrid_ntt.launches.update(head=0, hybrid=0)
    results = [(hybrid_ntt.ntt_fwd_head(x, p), hybrid_ntt.ntt_fwd_hybrid(x, p))
               for _, p, x in inputs]
    torch.cuda.synchronize()
    counts = dict(hybrid_ntt.launches)
    print(f"radix path: launches head {counts['head']}, hybrid {counts['hybrid']}", flush=True)
    worst = 0
    for (label, p, x), (head, full) in zip(inputs, results):
        t = p.tables(dev)
        errs = {
            "head==head_plain": max_err(head, hybrid_ntt.ntt_fwd_head_plain(x, p)),
            "hybrid==chain": max_err(full, ntt.ntt_fwd(x, t.psi_rev, t.moduli)),
            "hybrid==K1": max_err(full, four_step.four_step_ntt_fwd(x, p, p.n // 128)),
            "hybrid==hybrid_plain[:8]": max_err(full[:, :8],
                                                hybrid_ntt.ntt_fwd_hybrid_plain(x[:, :8], p)),
        }
        torch.cuda.synchronize()
        print(f"check K3 {label} n={p.n} L={p.crt_depth} B={x.shape[1]}: "
              + ", ".join(f"{k} max|d| {v}" for k, v in errs.items())
              + " (tolerance 0: bit-exact)", flush=True)
        worst = max(worst, *errs.values())
    if worst != 0 or counts["head"] == 0 or counts["hybrid"] == 0:
        raise SystemExit("chip_smoke: the radix-2 kernel disagrees or did not launch")
    return counts, worst


def bgg_circuit(p, dev):
    """The circuit of phase 5 and its inputs: (circuit, public keys,
    encodings, plaintexts, encoding sampler)."""
    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.gadgets import secret_inner_product
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

    n_in = N_BGG_INPUTS
    c = PolyCircuit()
    pub = c.input(n_in)
    sec = c.input(n_in)
    scaled = [c.small_scalar_mul(pub[i], [i + 1]) for i in range(8)]
    scaled += [c.large_scalar_mul(pub[i], [2**20 + i]) for i in range(8, n_in)]
    ip = secret_inner_product(c, scaled, list(sec))
    c.output([ip] + [c.sub_gate(scaled[j], scaled[j + 4]) for j in range(4)])

    us = UniformSampler(seed=11, device=dev)
    secret = us.sample_poly(p, TernaryDist())
    plain = [Poly.const(p, 3 * i + 1, dev) for i in range(n_in)]
    plain += [us.sample_poly(p, TernaryDist()) for _ in range(n_in)]
    pks = BGGPublicKeySampler(BGG_KEY, 1, device=dev).sample(
        p, b"chip_smoke", [True] * n_in + [False] * n_in)
    es = BGGEncodingSampler(p, [secret], gauss_sigma=None)
    encs = es.sample(p, pks, plain)
    return c, pks, encs, plain, es


def drive_bgg(p, dev) -> dict:
    """Phase 5: both passes, sequential and batched, checked exactly."""
    import torch

    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ops import four_step
    from mxx_tpu_torch.ring.poly import Poly

    c, pks, encs, plain, es = bgg_circuit(p, dev)
    torch.cuda.synchronize()
    four_step.launches.update(fwd=0, inv=0)
    seq_pk = c.eval(p, pks[0], pks[1:])
    bat_pk = eval_batched(c, p, pks[0], pks[1:])
    seq_enc = c.eval(p, encs[0], encs[1:])
    bat_enc = eval_batched(c, p, encs[0], encs[1:])
    torch.cuda.synchronize()
    counts = dict(four_step.launches)
    x_out = c.eval(p, Poly.one(p, dev), plain)  # the plaintext oracle
    s_g = es.secret_vec @ PolyMatrix.gadget_matrix(p, 1, dev)
    ok_pk = all(a == b for a, b in zip(seq_pk, bat_pk))
    ok_enc = all(a == b for a, b in zip(seq_enc, bat_enc))
    ok_keys = all(e.pubkey == k for e, k in zip(bat_enc, bat_pk))
    ok_decode = all(e.vector == es.secret_vec @ e.pubkey.matrix - s_g.mul_poly_scalar(x)
                    for e, x in zip(bat_enc, x_out))
    ok_pt = all(e.plaintext is None or e.plaintext == x for e, x in zip(bat_enc, x_out))
    ok_shape = all(e.vector.data.shape == (p.crt_depth, 1, p.modulus_digits, p.n)
                   for e in bat_enc)
    torch.cuda.synchronize()
    print(f"bgg circuit n={p.n} L={p.crt_depth} d=1, {N_BGG_INPUTS}+{N_BGG_INPUTS} inputs, "
          f"{c.gate_counts()}: pubkeys batched==sequential {ok_pk}, encodings batched=="
          f"sequential {ok_enc}, encoding pubkeys == pubkey pass {ok_keys}, "
          f"c == s A - x (s G) {ok_decode}, plaintexts == oracle {ok_pt}, shapes {ok_shape} "
          f"(tolerance 0: exact); launches in the phase: fwd {counts['fwd']}, "
          f"inv {counts['inv']}", flush=True)
    if not all((ok_pk, ok_enc, ok_keys, ok_decode, ok_pt, ok_shape)):
        raise SystemExit("chip_smoke: BGG circuit check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the BGG phase did not go through both four-step kernels")
    return {"params": p, "circuit": c, "pks": pks, "encs": encs, "launches": counts}


# the stage of a device kernel: the innermost port module on the Python stack
# of the op that launched it (the profiler's stack frames, innermost first)
STAGE_FILES = [
    ("mxx_tpu_torch/ops/four_step.py", "transforms"),
    ("mxx_tpu_torch/ops/hybrid_ntt.py", "transforms"),
    ("mxx_tpu_torch/ring/ntt.py", "transforms"),
    ("mxx_tpu_torch/ops/decompose.py", "digit_decompose"),
    ("mxx_tpu_torch/ops/zq_matmul.py", "zq_matmul"),
    ("mxx_tpu_torch/ops/elementwise.py", "elementwise"),
    ("mxx_tpu_torch/sampler/chacha.py", "chacha20"),
    ("mxx_tpu_torch/sampler/", "samplers (other)"),
]
NTT_KERNELS = ("four_step_kernel", "radix_ntt_fwd_kernel")


def kernel_stage(stack) -> str:
    for frame in stack:
        for path, stage in STAGE_FILES:
            if path in frame:
                return stage
    return "other device work"


def profiled_stages(label, fn, timing) -> None:
    """One call of fn under torch.profiler, after a warm-up call: device time
    by stage and the device's idle share of the call (an upper bound: the
    profiler slows the host). The hand-written NTT kernels are launched
    through ctypes, outside any torch op, so they are found by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True,
                 experimental_config=torch._C._profiler._ExperimentalConfig(verbose=True)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in device) * 1e-3
    stages = dict.fromkeys([stage for _, stage in STAGE_FILES] + ["other device work"], 0.0)
    stages["transforms"] = sum(e.time_range.elapsed_us() for e in device
                               if any(k in e.name for k in NTT_KERNELS)) * 1e-3
    for e in events:
        if e.device_type.name == "CPU" and e.kernels:
            stage = kernel_stage(e.stack)
            stages[stage] += sum(k.duration for k in e.kernels
                                 if not any(n in k.name for n in NTT_KERNELS)) * 1e-3
    unattributed = busy - sum(stages.values())
    parts = ", ".join(f"{k} {v:.3f} ms ({v / wall:.1%})" for k, v in stages.items())
    timing(label, wall, "ms",
           f": {len(device)} device kernels, device busy {busy:.3f} ms: {parts}, "
           f"unattributed {unattributed:.3f} ms; device idle {wall - busy:.3f} ms "
           f"({1 - busy / wall:.1%} of the call)")


def mod_p_lut(p):
    """The 49-entry mod-p LUT x -> (row x, x mod p)."""
    from mxx_tpu_torch.lookup import PublicLut

    return PublicLut.from_dict(p, {x: (x, x % P_MOD) for x in range(P_MOD * P_MOD)})


def mod_p_chain(p):
    """scripts/realistic_scale_run.py's circuit: Mul -> PubLut -> Mul -> PubLut
    over the mod-p LUT."""
    from mxx_tpu_torch.circuit import PolyCircuit

    c = PolyCircuit()
    ins = c.input(3)
    lut_id = c.register_public_lut(mod_p_lut(p))
    t1 = c.public_lookup_gate(c.mul_gate(ins[0], ins[1]), lut_id)
    c.output([c.public_lookup_gate(c.mul_gate(t1, ins[2]), lut_id)])
    return c


class SpanLog(logging.Handler):
    """Collects the port's span and event records (utils/tracing.py)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def total_ms(self, name) -> float:
        return sum(r.elapsed_ms for r in self.records if getattr(r, "span", None) == name)

    def events(self, name) -> list[dict]:
        return [r.fields for r in self.records if getattr(r, "event", None) == name]

    def __enter__(self):
        log = logging.getLogger("mxx_tpu_torch")
        self._saved = (log.level, log.propagate)
        log.setLevel(logging.INFO)
        log.propagate = False
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("mxx_tpu_torch")
        log.removeHandler(self)
        log.setLevel(self._saved[0])
        log.propagate = self._saved[1]


def drive_lwe_lut(p, dev, timing) -> dict:
    """The LWE public-LUT chain of scripts/realistic_scale_run.py on the
    port: plaintext oracle, offline pubkey pass, K_high sampling and writes
    (`sample_aux_matrices`, `wait_for_all_writes`), online encoding pass and
    the masked-rounding decode; then every stored K_high row is read back
    (each batch part once) and held to B K_high == target exactly. Returns
    the K1/K2 launch counts of the chain."""
    import random
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.lookup import (
        LWEBGGEncodingPltEvaluator,
        LWEBGGPubKeyPltEvaluator,
        PolyPltEvaluator,
    )
    from mxx_tpu_torch.lookup.lwe import k_high_checkpoint_prefix
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ops import four_step
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, TrapdoorSampler, UniformSampler
    from mxx_tpu_torch.storage import (
        init_storage_system,
        read_matrices_from_multi_batch,
        wait_for_all_writes,
    )

    q = p.modulus
    q_over_p = q // P_MOD
    k = p.modulus_digits
    circuit = mod_p_chain(p)
    rng = random.Random(4242)
    a, b, c = (rng.randrange(P_MOD) for _ in range(3))
    expected = ((a * b) % P_MOD) * c % P_MOD
    plaintexts = [Poly.const(p, v, dev) for v in (a, b, c)]
    secrets = [UniformSampler(seed=99, device=dev).sample_poly(p, TernaryDist())]
    pubkeys = BGGPublicKeySampler(BGG_KEY, 1, device=dev).sample(p, b"realistic", [True] * 3)
    es = BGGEncodingSampler(p, secrets, gauss_sigma=4.0, seed=98)
    encodings = es.sample(p, pubkeys, plaintexts)
    trap = TrapdoorSampler(p, 4.578, seed=97, device=dev)
    td, b0 = trap.trapdoor(p, 1)

    n_luts = circuit.gate_counts()["PubLut"]
    entries = P_MOD * P_MOD
    row_bytes = 25 + p.crt_depth * (2 + k) * k * p.n * 4  # one K_high's compact bytes
    want_bytes = n_luts * entries * row_bytes
    with tempfile.TemporaryDirectory(prefix="mxx_lwe_lut_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"lwe lut chain: K_high artifacts {n_luts} gates x {entries} rows x "
              f"{row_bytes} B = {want_bytes} B to {tmp}; free there {free} B", flush=True)
        if free < 2 * want_bytes:
            raise SystemExit(f"chip_smoke: {tmp} has {free} B free, under twice the "
                             f"{want_bytes} B of K_high artifacts the LWE LUT chain writes")
        init_storage_system(tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        four_step.launches.update(fwd=0, inv=0)
        ms = {}

        def clock(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        pt = clock("plaintext oracle", lambda: circuit.eval(
            p, Poly.one(p, dev), plaintexts, plt_evaluator=PolyPltEvaluator())[0])
        pk_eval = LWEBGGPubKeyPltEvaluator(BGG_KEY, trap, b0, td, tmp)
        out_pk = clock("pubkey pass", lambda: circuit.eval(
            p, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0])
        states = dict(pk_eval.gate_state)
        with SpanLog() as spans:
            clock("sample_aux_matrices", lambda: pk_eval.sample_aux_matrices(p))
            clock("wait_for_all_writes", wait_for_all_writes)
        c_b = es.secret_vec @ b0
        enc_eval = LWEBGGEncodingPltEvaluator(BGG_KEY, tmp, c_b)
        enc = clock("encoding pass", lambda: circuit.eval(
            p, encodings[0], encodings[1:], plt_evaluator=enc_eval)[0])

        def decode():
            s_g = es.secret_vec @ PolyMatrix.gadget_matrix(p, 1, dev)
            diff = enc.vector - es.secret_vec @ enc.pubkey.matrix + s_g.mul_poly_scalar(
                enc.plaintext)
            coeff = diff.entry(0, 0).const_coeff()
            mask = rng.randrange(P_MOD)
            rounded = (coeff + q_over_p * mask + q_over_p // 2) // q_over_p
            return min(coeff, q - coeff), rounded % P_MOD == mask

        err, mask_ok = clock("decode", decode)
        counts = dict(four_step.launches)
        peak = torch.cuda.max_memory_allocated()

        ok_oracle = pt.const_coeff() == expected and enc.plaintext.const_coeff() == expected
        ok_alt = enc.pubkey == out_pk
        budget = q_over_p // 2
        ok_decode = err < budget and mask_ok
        # every stored row: B K_high == its target, each batch part read once
        rows = 0
        bad = []
        written = sum(f.stat().st_size for f in Path(tmp).iterdir() if f.suffix == ".bin")
        parts = sum(1 for f in Path(tmp).iterdir() if f.suffix == ".bin")
        for (ctx, gate_id, slot), st in states.items():
            targets = pk_eval._k_high_targets(p, st.plt, st.input_pubkey, st.output_pubkey,
                                              gate_id, st.lut_id, slot, ctx)
            by_row = {int(kk): t for (_, (kk, _)), t in zip(st.plt.entries(p), targets)}
            prefix = k_high_checkpoint_prefix(gate_id, st.lut_id, slot, ctx)
            for idx, k_high in read_matrices_from_multi_batch(p, tmp, prefix, dev):
                target = by_row.pop(idx, None)
                if target is None or k_high.shape != (2 + k, k) or not b0 @ k_high == target:
                    bad.append((gate_id, idx))
                rows += 1
            bad.extend((gate_id, idx) for idx in by_row)  # rows never stored
            del targets, by_row
        ok_rows = not bad and rows == n_luts * entries
        torch.cuda.synchronize()
    err_bits = math.log2(err) if err else 0.0
    print(f"lwe lut chain n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits "
          f"{p.base_bits} d=1 p={P_MOD}, {entries}-entry LUT, {circuit.gate_counts()}: "
          f"plaintext == oracle {ok_oracle}, A_LT online == offline {ok_alt}, "
          f"B K_high == target for {rows - len(bad)} of {n_luts * entries} stored rows "
          f"{ok_rows} (tolerance 0: exact), decode {ok_decode} (error {err} = 2^{err_bits:.2f} "
          f"under the q/(2p) budget {budget} = 2^{math.log2(budget):.2f}); launches in the "
          f"chain: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    if not all((ok_oracle, ok_alt, ok_rows, ok_decode)):
        raise SystemExit(f"chip_smoke: LWE LUT chain check failed (bad rows {bad[:5]})")

    cols = sum(r.fields["cols"] for r in spans.records
               if getattr(r, "span", None) == "lwe_lut.k_high_preimages")
    writes = spans.events("storage.write_part")
    write_ms = sum(w["elapsed_ms"] for w in writes)
    pre_ms = spans.total_ms("lwe_lut.k_high_preimages")
    d2h_ms = spans.total_ms("storage.device_to_host")
    ser_ms = spans.total_ms("storage.serialize")
    for name in ("plaintext oracle", "pubkey pass"):
        timing(f"lwe lut chain: {name}", ms[name], "ms")
    timing("lwe lut chain: sample_aux_matrices", ms["sample_aux_matrices"], "ms",
           f" ({n_luts} gates)")
    timing("lwe lut chain: target assembly", spans.total_ms("lwe_lut.k_high_targets"), "ms",
           f" ({n_luts * entries} targets)")
    timing("lwe lut chain: K_high preimages", cols / pre_ms * 1e3, "preimage-cols/s",
           f" ({pre_ms:.1f} ms for {cols} cols)")
    timing("lwe lut chain: device-to-host copy + serialize", d2h_ms + ser_ms, "ms",
           f" ({want_bytes / (d2h_ms + ser_ms) / 1e6:.3f} GB/s; copy {d2h_ms:.1f} ms, "
           f"{want_bytes / d2h_ms / 1e6:.3f} GB/s; serialize {ser_ms:.1f} ms, "
           f"{want_bytes / ser_ms / 1e6:.3f} GB/s)")
    timing("lwe lut chain: disk write, summed over writer threads", write_ms, "ms",
           f" ({written} B in {parts} batch files, {written / write_ms / 1e6:.3f} GB/s "
           f"per thread; wait_for_all_writes {ms['wait_for_all_writes']:.1f} ms)")
    timing("lwe lut chain: encoding pass", ms["encoding pass"], "ms")
    timing("lwe lut chain: decode", ms["decode"], "ms")
    print(f"lwe lut chain: bytes written {written} (reckoned {want_bytes} of payloads)",
          flush=True)
    timing("lwe lut chain: peak device memory", peak / 1e9, "GB")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the LWE LUT chain did not go through both four-step kernels")
    return counts


def drive_debug_lut(p, dev) -> None:
    """One level of 8 PubLut gates through the debug evaluators: the pubkey
    and encoding passes sequential and batched, batched == sequential, the
    sequential encodings through RelationCheckingPltEvaluator and the
    batched ones checked c = s A - y (s G) exactly."""
    import torch

    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.lookup import (
        DebugBGGEncodingPltEvaluator,
        DebugBGGPubKeyPltEvaluator,
        PolyPltEvaluator,
        RelationCheckingPltEvaluator,
    )
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

    n_lut = 8
    c = PolyCircuit()
    ins = c.input(n_lut + 1)
    lut_id = c.register_public_lut(mod_p_lut(p))
    c.output([c.public_lookup_gate(c.mul_gate(ins[i], ins[i + 1]), lut_id)
              for i in range(n_lut)])
    plain = [Poly.const(p, (3 * i + 2) % P_MOD, dev) for i in range(n_lut + 1)]
    pks = BGGPublicKeySampler(BGG_KEY, 1, device=dev).sample(p, b"debug_lut", [True] * (n_lut + 1))
    es = BGGEncodingSampler(p, [UniformSampler(seed=12, device=dev).sample_poly(p, TernaryDist())])
    encs = es.sample(p, pks, plain)
    s = es.secret_vec
    pk_seq = c.eval(p, pks[0], pks[1:], plt_evaluator=DebugBGGPubKeyPltEvaluator(BGG_KEY))
    pk_bat = eval_batched(c, p, pks[0], pks[1:], DebugBGGPubKeyPltEvaluator(BGG_KEY))
    enc_seq = c.eval(p, encs[0], encs[1:], plt_evaluator=RelationCheckingPltEvaluator(
        DebugBGGEncodingPltEvaluator(BGG_KEY, s), s))  # raises on a relation violated
    enc_bat = eval_batched(c, p, encs[0], encs[1:], DebugBGGEncodingPltEvaluator(BGG_KEY, s))
    x_out = c.eval(p, Poly.one(p, dev), plain, plt_evaluator=PolyPltEvaluator())
    s_g = s @ PolyMatrix.gadget_matrix(p, 1, dev)
    ok_pk = all(a == b for a, b in zip(pk_seq, pk_bat))
    ok_enc = all(a == b for a, b in zip(enc_seq, enc_bat))
    ok_keys = all(e.pubkey == k for e, k in zip(enc_bat, pk_bat))
    ok_rel = all(e.vector == s @ e.pubkey.matrix - s_g.mul_poly_scalar(x) and e.plaintext == x
                 for e, x in zip(enc_bat, x_out))
    torch.cuda.synchronize()
    print(f"debug lut batch n={p.n} L={p.crt_depth}, one level of {n_lut} PubLut gates: "
          f"pubkeys batched==sequential {ok_pk}, encodings batched==sequential {ok_enc}, "
          f"encoding pubkeys == pubkey pass {ok_keys}, relation c = s A - y (s G) exact "
          f"{ok_rel} (tolerance 0: exact; sequential pass through "
          f"RelationCheckingPltEvaluator)", flush=True)
    if not all((ok_pk, ok_enc, ok_keys, ok_rel)):
        raise SystemExit("chip_smoke: debug LUT batch check failed")


def max_centered(p, m) -> int:
    """max |c| over every coefficient c of m, centered mod q. Garner's
    mixed-radix digits (exact int64 on the device) rank the coefficients by
    a float64 magnitude; the largest is then reconstructed exactly."""
    import torch

    x = m.to_coeff().data.reshape(p.crt_depth, -1)
    qs = [int(v) for v in p.moduli]

    def magnitude(r):
        digits = [r[0]]
        for i in range(1, len(qs)):
            t = r[i]
            for j in range(i):
                t = (t - digits[j] % qs[i]) * pow(qs[j], -1, qs[i]) % qs[i]
            digits.append(t)
        radix = [float(math.prod(qs[:i])) for i in range(len(qs))]
        return sum(d.to(torch.float64) * w for d, w in zip(digits, radix))

    neg = (-x) % p.tables(x.device).moduli[:, None]
    mag = torch.minimum(magnitude(x), magnitude(neg))
    at = int(torch.argmax(mag))
    v = p.reconstruct_coeff(x[:, at].cpu().numpy())
    return min(v, p.modulus - v)


def decode_margin(q: int, coeff: int) -> str:
    """A decoded coefficient's distance from the nearer decision boundary
    (q/4 or 3q/4) of the protocols' bit decode, and from the nearer ideal
    value (0 or q/2): its error."""
    margin = min(abs(coeff - q // 4), abs(coeff - 3 * (q // 4)))
    error = min(coeff, q - coeff, abs(coeff - q // 2))
    return (f"margin 2^{math.log2(max(margin, 1)):.4f} (error 2^{math.log2(max(error, 1)):.2f}) "
            f"of q/4 = 2^{math.log2(q // 4):.4f}")


def instrument(obj, name: str, log: dict, label: str, size=None) -> None:
    """Wrap obj.name: each call synchronizes the card before and after, and
    appends (ms, size(args, result)) to log[label]."""
    import torch

    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.setdefault(label, []).append(
            ((time.perf_counter() - t0) * 1e3, size(args, out) if size else 0))
        return out

    setattr(obj, name, wrapped)


def we_encryption(p, dev, msg: bool, check_states: bool, timing) -> bool:
    """One Diamond WE encryption of `msg` through `enc` and `dec` with the
    witness [False, True], in its own temporary directory (deleted when its
    checks are done); with `check_states`, every final injector state is
    held to its simulated error bound. Prints its checks and times and
    returns whether they held."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.input_injector import DiamondInjector
    from mxx_tpu_torch.input_injector.simulation import simulate_output_error_bounds
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.we import DiamondWE

    q = p.modulus
    circuit = PolyCircuit()
    ins = circuit.input(3)
    circuit.output([circuit.or_gate(ins[0], ins[1])])
    witness = [False, True]
    k_bytes = 25 + p.crt_depth * 36 * 36 * p.n * 4  # one transition K at d=1, k=16
    log: dict = {}
    on_card = []  # every read matrix and every state: on the card?
    with tempfile.TemporaryDirectory(prefix="mxx_diamond_we_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < 2 * 13 * k_bytes:
            raise SystemExit(f"chip_smoke: {tmp} has {free} B free, under twice the "
                             f"~{13 * k_bytes} B of one WE encryption's artifacts")
        injector = DiamondInjector(p, 2, 2, 1, 4.578, 4.0, seed=4090 + msg, device=dev)
        we = DiamondWE(injector, 2, tmp, b"diamond_we_chip", seed=4091 + msg)
        instrument(injector._trap, "trapdoor", log, "trapdoor")
        peaks = []  # peak device memory after each transition preimage call
        instrument(injector._trap, "preimage_batched_chunked", log, "transition preimages",
                   lambda a, out: peaks.append(torch.cuda.max_memory_allocated())
                   or sum(t.ncol for t in a[3]))
        instrument(injector, "_write_matrix", log, "write",
                   lambda a, out: injector._mpath(a[0], a[1]).stat().st_size)
        instrument(injector, "read_matrix", log, "read",
                   lambda a, out: on_card.append(out.data.is_cuda)
                   or injector._mpath(a[0], a[1]).stat().st_size)
        instrument(injector, "online_eval", log, "online_eval",
                   lambda a, out: on_card.extend(s.data.is_cuda for s in out) or out)
        instrument(we._trap, "preimage", log, "output preimages", lambda a, out: a[3].ncol)
        instrument(we, "_read", log, "preimage reads",
                   lambda a, out: on_card.append(out.data.is_cuda) or 0)
        instrument(circuit, "eval", log, "circuit eval")
        instrument(we, "_noisy_coeff", log, "noisy", lambda a, out: out)
        with SpanLog() as spans:
            t0 = time.perf_counter()
            ct = we.enc(msg, circuit, [False])
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
            artifacts = sum(f.stat().st_size for f in Path(tmp).iterdir())
            t0 = time.perf_counter()
            got = we.dec(ct, witness)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3
        totals = {label: (sum(ms for ms, _ in calls), len(calls),
                          sum(s for _, s in calls) if label != "online_eval" else 0)
                  for label, calls in log.items()}
        states = log["online_eval"][0][1]
        # 6 K chain reads (p_eps, 2 + 3 K), 3 states, 5 output preimages
        n_card = len(on_card)
        ok_card = all(on_card) and n_card == 6 + 3 + 5
        bounds = []
        if check_states:
            digits = we._pack_witness_digits(witness)
            sigma = injector.debug_final_secret_matrix(tmp, digits).entry(0, 0)
            sim = simulate_output_error_bounds(injector)
            for i, state in enumerate(states):
                # state 0 carries k (0 for msg False), bit state i the bit of digit i-1
                x = (Poly.const(p, q // 2, dev) if msg else Poly.zero(p, device=dev)) if i == 0 \
                    else sigma * Poly.const(p, injector.digit_bit_value(digits[i - 1], 0), dev)
                want = PolyMatrix.from_poly_row(p, [sigma, x]) @ ct.preprocess_out.final_pub_matrices[i]
                err = max_centered(p, state - want)
                bound = int(sim.state_errors[i].poly_norm.norm)
                bounds.append((err, bound, 0 < err <= bound < q // 4))
        del states, ct
        torch.cuda.synchronize()
    ok = got == msg and ok_card and all(b[2] for b in bounds)
    print(f"diamond we n={p.n} L={p.crt_depth} msg {msg}: decode {got} == msg {got == msg}, "
          f"{decode_margin(q, log['noisy'][0][1])}; states and read preimages on the card "
          f"{ok_card} ({n_card} checked)" + "".join(
              f"; state {i}: error {e} = 2^{math.log2(max(e, 1)):.2f} <= simulated bound {b} = "
              f"2^{math.log2(b):.2f} < q/4 {good}" for i, (e, b, good) in enumerate(bounds)),
          flush=True)
    tag = f"diamond we (msg {msg})"
    tr_ms, tr_n, _ = totals["trapdoor"]
    pi_ms, pi_n, pi_cols = totals["transition preimages"]
    wr_ms, wr_n, wr_bytes = totals["write"]
    op_ms, op_n, op_cols = totals["output preimages"]
    on_ms, _, _ = totals["online_eval"]
    rd_ms, rd_n, rd_bytes = totals["read"]
    (pk_eval_ms, _), (enc_eval_ms, _) = log["circuit eval"]
    timing(f"{tag}: enc", enc_ms, "ms", f" ({artifacts} B of artifacts)")
    timing(f"{tag}: preprocess", spans.total_ms("diamond_injector.preprocess"), "ms")
    timing(f"{tag}: trapdoor sampling", tr_ms, "ms", f" ({tr_n} trapdoors)")
    timing(f"{tag}: transition preimages", pi_cols / pi_ms * 1e3, "preimage-cols/s",
           f" ({pi_ms:.1f} ms, {pi_n} calls, {pi_cols} cols; peak device memory after each "
           f"call " + ", ".join(f"{v / 1e9:.4f}" for v in peaks) + " GB)")
    timing(f"{tag}: _write_matrix", wr_ms, "ms",
           f" ({wr_bytes} B in {wr_n} matrices, {wr_bytes / wr_ms / 1e6:.3f} GB/s)")
    timing(f"{tag}: pubkey circuit eval", pk_eval_ms, "ms")
    timing(f"{tag}: output preimages", op_ms, "ms", f" ({op_n} calls, {op_cols} cols)")
    timing(f"{tag}: dec", dec_ms, "ms")
    timing(f"{tag}: online_eval", on_ms, "ms",
           f" ({rd_bytes} B read in {rd_n} matrices, {rd_ms:.1f} ms of it in reads, "
           f"{rd_bytes / rd_ms / 1e6:.3f} GB/s)")
    timing(f"{tag}: encoding circuit eval", enc_eval_ms, "ms")
    timing(f"{tag}: dec after online_eval (projections, circuit eval, decode)",
           dec_ms - on_ms, "ms")
    return ok


def drive_diamond_we(p, dev, timing) -> dict:
    """Diamond WE: one encryption of each message, each with a fresh
    injector, the first one's final states held to their bounds. Returns
    the K1/K2 launch counts of the phase."""
    import torch

    from mxx_tpu_torch.ops import four_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing("diamond we: device memory allocated at the start",
           torch.cuda.memory_allocated() / 1e9, "GB")
    four_step.launches.update(fwd=0, inv=0)
    ok = [we_encryption(p, dev, msg, not msg, timing) for msg in (False, True)]
    torch.cuda.synchronize()
    counts = dict(four_step.launches)
    timing("diamond we: peak device memory", torch.cuda.max_memory_allocated() / 1e9, "GB")
    print(f"diamond we: launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}",
          flush=True)
    if not all(ok):
        raise SystemExit("chip_smoke: Diamond WE check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the Diamond WE phase did not go through both four-step "
                         "kernels")
    return counts


def drive_aky24_fe(p, dev, timing) -> dict:
    """AKY24 FE through setup, keygen, enc and dec of four messages, checked
    against f(x) and the exact K_f relation. Returns the K1/K2 launch counts
    of the phase."""
    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.func_enc import Aky24FuncEnc
    from mxx_tpu_torch.ops import four_step

    def f(x):
        return x[0] ^ x[1] ^ (x[2] & x[3]) ^ (x[4] | x[5]) ^ (x[6] & x[7])

    c = PolyCircuit()
    x = c.input(8)
    c.output([c.xor_gate(c.xor_gate(c.xor_gate(c.xor_gate(
        x[0], x[1]), c.and_gate(x[2], x[3])), c.or_gate(x[4], x[5])), c.and_gate(x[6], x[7]))])
    msgs = [[0] * 8, [1, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 1, 1, 0, 1, 1], [1, 1, 0, 1, 0, 1, 1, 0]]
    want = [f(m) for m in msgs]
    assert set(want) == {0, 1}
    q = p.modulus
    fe = Aky24FuncEnc(msg_bits=8, error_sigma=3.0, seed=4242, device=dev)
    log: dict = {}
    instrument(fe, "_noisy_coeff", log, "noisy", lambda a, out: out)
    ms = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    four_step.launches.update(fwd=0, inv=0)
    _, msk = clock("setup", lambda: fe.setup(p))
    fsk = clock("keygen", lambda: fe.keygen(p, msk, c))
    got = []
    for m in msgs:
        ct = clock("enc", lambda m=m: fe.enc(p, msk, m))
        got.append(clock("dec", lambda ct=ct: fe.dec(p, ct, fsk, c)))
    torch.cuda.synchronize()
    counts = dict(four_step.launches)
    pks = fe._pubkeys(p)
    target = c.eval(p, pks[0], pks[1:])[0].matrix @ fe._decode_selector(p)
    ok_rel = msk.b_matrix @ fsk.k_f == target
    ok_card = all(t.data.is_cuda for t in (msk.b_matrix, fsk.k_f, target))
    print(f"aky24 fe n={p.n} L={p.crt_depth} d=2, 8 inputs, {c.gate_counts()}: decodes {got} "
          f"== f(x) {want} {got == want}, B K_f == A_f G^-1((q/2) e_last) {ok_rel} "
          f"(tolerance 0: exact), on the card {ok_card}; decodes: "
          + "; ".join(decode_margin(q, v) for _, v in log["noisy"])
          + f"; launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    for name, values in ms.items():
        timing(f"aky24 fe: {name}", statistics.median(values), "ms",
               f" (median of {len(values)})" if len(values) > 1 else "")
    if not (got == want and ok_rel and ok_card):
        raise SystemExit("chip_smoke: AKY24 FE check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the AKY24 FE phase did not go through both four-step "
                         "kernels")
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mxx_tpu_torch.ops import four_step, hybrid_ntt
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    def timing(metric, value, unit, extra=""):
        print(f"timing: {metric} = {value:.4f} {unit}{extra} [{card}]", flush=True)

    shapes = [("A", (8192, 8, 28, 14), 512), ("B", (16384, 10, 24, 12), 64)]

    # 1. build
    build_kernels([four_step, hybrid_ntt])

    # 2. K1 and K2 against the radix chain and the plain four-step
    check_four_step(dev, shapes + [("C", (16384, 10, 24, 12), 1000)])
    torch.cuda.empty_cache()

    # 3. the radix-2 kernel's path
    radix_counts, radix_err = drive_radix(dev, shapes)
    torch.cuda.empty_cache()

    # 4. the main path
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

    # 5. BGG+ circuit evaluation
    bgg = drive_bgg(RingParams.new(8192, 8, 28, 14), dev)
    bgg_counts = bgg["launches"]
    torch.cuda.empty_cache()

    # 6. the debug LUT evaluators, batched, at the same ring
    drive_debug_lut(RingParams.new(8192, 8, 28, 14), dev)

    # 7. the LWE public-LUT chain at the realistic-scale workload
    lut_counts = drive_lwe_lut(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 8. Diamond witness encryption at the same ring
    we_counts = drive_diamond_we(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 9. AKY24 functional encryption at the same ring
    fe_counts = drive_aky24_fe(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 10. timings
    p = RingParams.new(8192, 8, 28, 14)
    t = p.tables(dev)
    xa = residues(p, (512,), 4, dev)
    ms_kernel = cuda_ms(lambda: four_step.four_step_ntt_fwd(xa, p, 64), 10)
    ms_radix = cuda_ms(lambda: hybrid_ntt.ntt_fwd_hybrid(xa, p), 10)
    ms_chain = cuda_ms(lambda: ntt.ntt_fwd(xa, t.psi_rev, t.moduli), 5)
    ms_inv = cuda_ms(lambda: four_step.four_step_ntt_inv(xa, p, 64), 10)
    at_a = {}
    for name, ms in (("four_step_ntt_fwd", ms_kernel), ("four_step_ntt_inv", ms_inv)):
        bound = ntt_bound(xa.shape, products=ntt_products(p.n, p.n, twist=True))
        at_a[name] = {"shape": list(xa.shape), "ms": ms, "bound_ms": bound["bound_ms"],
                      "pct_of_bound": 100 * bound["bound_ms"] / ms}
        timing(f"{name} {list(xa.shape)}", ms, "ms",
               f" ({at_a[name]['pct_of_bound']:.1f}% of its bound {bound['bound_ms']:.4f} ms, "
               f"bound by {bound['bound_by']}; integer floor {bound['int_floor_ms']:.4f} ms)")
    timing("ntt_fwd n=8192 L=8 B=512, four-step kernel (K1)", 8 * 512 / ms_kernel * 1e3,
           "limb-NTTs/s", f" ({ms_kernel:.3f} ms)")
    timing("ntt_fwd n=8192 L=8 B=512, radix-2 kernel ntt_fwd_hybrid (K3)",
           8 * 512 / ms_radix * 1e3, "limb-NTTs/s", f" ({ms_radix:.3f} ms)")
    timing("ntt_fwd n=8192 L=8 B=512, radix chain (plain torch)", 8 * 512 / ms_chain * 1e3,
           "limb-NTTs/s", f" ({ms_chain:.3f} ms)")
    del xa

    ms_pre = cuda_ms(lambda: ts.preimage(pp, td, a, target), 3)
    timing("preimage d=1 n=16384 L=10 cols=50", 50 / ms_pre * 1e3, "preimage-cols/s",
           f" ({ms_pre:.1f} ms per call)")
    profiled_stages("preimage d=1 n=16384 L=10 cols=50, profiled",
                    lambda: ts.preimage(pp, td, a, target), timing)

    pg = RingParams.new(8192, 8, 28, 14)
    us = UniformSampler(seed=4, device=dev)
    c_mat = us.sample_uniform(pg, 2, 2 * pg.modulus_digits, FinRingDist()).to_eval()
    cts = us.sample_uniform(pg, 2, 64, FinRingDist())
    ms_gsw = cuda_ms(lambda: c_mat @ cts.decompose(), 3)
    timing("gsw ext-prod n=8192 L=8 B=64", 64 / ms_gsw * 1e3, "ext-prods/s",
           f" ({ms_gsw:.1f} ms per call)")
    del c_mat, cts
    torch.cuda.empty_cache()

    from mxx_tpu_torch.circuit.batched_eval import eval_batched

    bp, bc = bgg["params"], bgg["circuit"]
    n_gates = sum(v for g, v in bc.gate_counts().items() if g != "Input")
    for label, wires in [("pubkey", bgg["pks"]), ("encoding", bgg["encs"])]:
        ms = cuda_ms(lambda w=wires: eval_batched(bc, bp, w[0], w[1:]), 3)
        timing(f"bgg {label} pass, batched, n=8192 L=8 d=1, {n_gates} gates", n_gates / ms * 1e3,
               "gates/s", f" ({ms:.1f} ms per pass)")
    encs = bgg["encs"]
    profiled_stages("bgg encoding pass, batched, profiled",
                    lambda: eval_batched(bc, bp, encs[0], encs[1:]), timing)
    del bgg
    torch.cuda.empty_cache()

    # each kernel against its plain version at the preimage's largest transform
    tpp = pp.tables(dev)
    xm = residues(pp, (1000,), 5, dev)
    kernels = []
    # K1/K2: `launches` is the LWE LUT chain's count; each path's own count
    # (each read around that path alone) is beside it
    by_path = {d: {"preimage": counts[d], "bgg circuit": bgg_counts[d],
                   "lwe lut chain": lut_counts[d], "diamond we": we_counts[d],
                   "aky24 fe": fe_counts[d]} for d in ("fwd", "inv")}
    cases = [
        ("four_step_ntt_fwd", "four_step_ntt.cu", "mxx_tpu/ops/pallas_four_step.py:135",
         lut_counts["fwd"],
         partial(four_step.four_step_ntt_fwd, xm, pp, 128),
         partial(four_step.four_step_ntt_fwd_plain, xm, pp, 128),
         partial(ntt.ntt_fwd, xm, tpp.psi_rev, tpp.moduli), 2, ntt_products(pp.n, pp.n, True)),
        ("four_step_ntt_inv", "four_step_ntt.cu", "mxx_tpu/ops/pallas_four_step.py:135",
         lut_counts["inv"],
         partial(four_step.four_step_ntt_inv, xm, pp, 128),
         partial(four_step.four_step_ntt_inv_plain, xm, pp, 128),
         partial(ntt.ntt_inv, xm, tpp.psi_inv_rev, tpp.n_inv, tpp.moduli), 2,
         ntt_products(pp.n, pp.n, True)),
        ("ntt_fwd_head", "radix_ntt.cu", "mxx_tpu/ops/pallas_ntt.py:37", radix_counts["head"],
         partial(hybrid_ntt.ntt_fwd_head, xm, pp),
         partial(hybrid_ntt.ntt_fwd_head_plain, xm, pp), None, 3,
         ntt_products(pp.n, pp.n // hybrid_ntt.LANE)),
        ("ntt_fwd_hybrid", "radix_ntt.cu", "mxx_tpu/ops/pallas_ntt.py:37",
         radix_counts["hybrid"],
         partial(hybrid_ntt.ntt_fwd_hybrid, xm, pp),
         partial(hybrid_ntt.ntt_fwd_hybrid_plain, xm, pp),
         partial(ntt.ntt_fwd, xm, tpp.psi_rev, tpp.moduli), 3, ntt_products(pp.n, pp.n)),
    ]
    for name, source, replaces, launches, run, plain, chain, plain_iters, products in cases:
        got = run()
        err = max_err(got, plain())
        if chain is not None:
            err = max(err, max_err(got, chain()))
        if source == "radix_ntt.cu":
            err = max(err, radix_err)
        del got
        ms = cuda_ms(run, 10)
        ms_plain = cuda_ms(plain, plain_iters)
        bound = ntt_bound(xm.shape, products)
        extra = (f" kernel ({100 * bound['bound_ms'] / ms:.1f}% of its bound "
                 f"{bound['bound_ms']:.4f} ms, bound by {bound['bound_by']}; integer floor "
                 f"{bound['int_floor_ms']:.4f} ms); plain version {ms_plain:.3f} ms")
        entry = {"name": name, "route": "cuda", "source": f"mxx_tpu_torch/csrc/{source}",
                 "replaces": replaces, "launches": launches, "max_abs_err": err,
                 "ms": ms, "plain_ms": ms_plain, "bound_ms": bound["bound_ms"],
                 "bound_by": bound["bound_by"], "bytes_ms": bound["bytes_ms"],
                 "int_floor_ms": bound["int_floor_ms"],
                 "pct_of_bound": 100 * bound["bound_ms"] / ms, "library_ms": None,
                 "library": "none: no PyTorch call computes an exact NTT mod q"}
        if source == "four_step_ntt.cu":
            entry["launches_by_path"] = by_path[name[-3:]]
            entry["at_shape_a"] = at_a[name]
        else:  # K3 runs on its own path only
            entry["launches_by_path"] = {"radix path": launches}
        if chain is not None:
            ms_chain = cuda_ms(chain, 3)
            entry["chain_ms"] = ms_chain
            extra += f", radix chain {ms_chain:.3f} ms"
        timing(f"{name} [10, 1000, 16384]", ms, "ms",
               f"{extra}, max |kernel - plain| {err} (tolerance 0: bit-exact)")
        if err != 0:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
        kernels.append(entry)
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
