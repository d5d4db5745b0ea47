#!/usr/bin/env python3
"""Smoke run of mxx_tpu_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout. It imports no jax and nothing of the JAX
package, needs one card, and exits non-zero on any failure (no CUDA device,
no package beside it, a kernel that does not build, launch or agree):

1. the card's name and power limit (nvidia-smi), then the builds, all
   started together: one nvcc per kernel source, one g++ for each of the
   host codec and writer;
2. the four-step NTT kernels (K1 forward, K2 inverse) against the radix
   chain (whole batch) and the plain four-step (first 8 polys), and the round
   trip, at
   A: n=2^13, L=8, crt_bits 28, base_bits 14, B=512 (n1 = 64),
   B: n=2^14, L=10, crt_bits 24, base_bits 12, B=64 (n1 = 128) and
   C: the same ring at B=1000, the preimage's largest transform;
3. the radix-2 kernel's path (K3): `ntt_fwd_head` and `ntt_fwd_hybrid` at
   shapes A and B, at n=2^15 (L=10, B=8; a cluster of 2 blocks), n=2^16
   (L=10, B=4; a cluster of 4) and n=256 (L=3, B=64), with their launch
   counters reset before and read after, then checked against their plain
   versions, the radix chain and (2048 <= n <= 16384) K1;
4. the main path: an MP12 trapdoor preimage at the bench shape
   (n=2^14, L=10, crt_bits 24, base_bits 12, d=1, sigma 4.578, seed 2,
   uniform 1x50 target), checked A x == U exactly, with the kernels' launch
   counters reset before the call and read after it: K1, K2 and the ChaCha20
   kernel each launched, and every keystream block of the call made by the
   ChaCha20 kernel;
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
   every stored row; each sub-phase timed by the port's tracing spans
   (their device time from CUDA events, without a synchronize);
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
10. one nested-RNS modular multiplication over BGG+ wires at the same ring
   (`RingGswContext(..., 8, 2, p_basis="wide")`, k = 11 wide p-moduli): the
   circuit a.mul(b).full_reduce() and its reconstruct(); the 176 residues of
   two seeded values mod Q lifted from the one wire by
   `lift_constants_batched`, onto public keys and onto encodings (error
   sigma 4.0); both passes through `eval_batched` with the debug LUT
   evaluators; checked: lifts == per-call `large_scalar_mul` on a sample,
   outputs decode to x y mod Q and equal the plaintext oracle, encoding
   public keys == pubkey pass, every output c = s A - pt (s G) exactly;
   gates/s, constants/s, the phase's peak device memory, and a profiled
   pubkey pass, its device time split by stage;
11. the trapdoor-backed noise refresh (trapdoor sigma 4.578, a size-2
   trapdoor, state0 = [sigma, 1] B0): (i) `DiamondNoiseRefresher` with
   v_bits 8, base_bits 4: a dirtied encoding of a Delta-aligned x comes out
   with refreshed.vector == sigma A' - x G exactly, and the dirty one did
   not satisfy it; (ii) the CRT-level-split `NoiseRefresherNaiveVec`
   (v_bits 6, base_bits 4) over all 8 levels, 520 preimage target columns:
   the recomposed wire exact for x_hat, |x_hat - x| within the rounding
   bound; B0 P == target for every preimage;
12. the masked high-bit decoder with `DirectoryDecoderArtifacts` in a
   temporary directory (deleted after): `preprocess_public_key_matrix` for 4
   hash-derived public keys, `online_decode` of encodings of
   (q/2) bit + a centered mask below q/4: the four bits come back and
   B0 preimage == target for each stored artifact; K1 and K2 launched in
   each of phases 10-12 (counters reset before, read after);
13. preimage-backed slot transfer at the same ring over packed encodings
   (S = 3 slots, d = 1, zero-error aux; the circuit of
   tests/test_slot_transfer_preimage.py: one slot transfer
   [(2, -), (0, x3), (1, -)] of [2, 5, 7], then a slot reduce of its
   output): the offline pass and `sample_aux_matrices` into a temporary
   directory, then a fresh online evaluator that only reads the artifacts;
   checked: online public keys == the offline pass, plaintexts [7, 6, 5]
   and 7 + 6X + 5X^2, c_s == sigma_s A - x_s sigma_s G exactly on every
   slot, B P == target for every preimage;
14. the GGH15 chain: phase 7's workload (n=2^13, L=8, d=1, error sigma 4.0
   in the encodings and in the GGH15 targets, trapdoor sigma 4.578, the
   49-entry mod-7 LUT, Mul -> PubLut -> Mul -> PubLut) with the GGH15
   evaluators: the pubkey pass, `sample_aux_matrices` and
   `wait_for_all_writes` into a temporary directory (4.47 GB of L_x and
   gate preimages; its free space is checked first; deleted after), then a
   fresh online evaluator that only reads the artifacts, and the same
   circuit over 4-slot packed encodings (one secret per slot, c_b0 rows
   S B0) through the same stored chain; checked: plaintexts == oracle on
   every slot, encoding pubkeys == pubkey pass, the error c - s A_out +
   y (s G) of the output and of every slot in (0, the bound of
   `simulate_max_error_norm` with `NormPltGGH15Evaluator`] and that bound
   under q/4, B1 L_x == target for all 49 stored L_x and B0 P == target for
   all 10 gate stages (targets captured at the preimage calls, error
   included); preimage-cols/s, the seconds of the trapdoors, preimages and
   stores, bytes written and GB/s, the online and packed passes;
15. WEE25 and the commitment-backed LUT at n=2^13, crt_bits 28, base_bits
   14, d=1, tree_base 2, cut to L=3 (COMMIT_RING; the printed line gives
   T_top's size by depth, which grows like k^5): the public params, a
   commit/open/verify over a tree of 8 uniform blocks (verify True, and
   False for a tampered message), then phase 14's chain over its 49-entry
   table with zero-error encodings: the offline pass and
   `commit_all_lut_matrices` into a temporary directory (deleted after),
   and a fresh online evaluator that reads the commitment preimage;
   checked: output pubkey == `derive_a_out_matrix`, plaintext == oracle,
   c == s (A_out - G y) exactly, B0 preimage == commit + B_1; and one
   `rlwe_encrypt` of random bits at n=2^13, L=8, every bit decrypted;
   times of the public params (preimage-cols/s), the commit, each opening
   and the online pass, and the phase's peak memory; K1 and K2 launched in
   each of phases 13-15 (counters reset before, read after);
16. `PolyMatrix.modulus_switch` of a uniform [1, 16] matrix at the same ring
   to each of its 8 limbs: every coefficient of 4 entries against the exact
   host rounding (c P + q // 2) // q mod P, and every residue against the
   plain limb-by-limb numpy version, zero mismatches;
17. Diamond iO in packed payload mode (payload_slots 4) with debug replay,
   the shape of the JAX package's test_diamond_io_packed_payload_e2e, at a
   ring cut to what the card holds (n=2^12, L=2, crt_bits 28, base_bits 14;
   the printed line gives the cut and the bytes that forced it): the CI PRF
   config, the debug LUT evaluators, XOR and AND of two bits; obfuscate,
   eval of [0, 1] and [1, 1]; checked: both decode to [a ^ b, a & b],
   c_one == sigma (A_one - G) exactly, K1/K2 launched in it;
18. the bench estimators: per-op costs measured on the card (each a
   warm-up, then the median wall time of a few runs between synchronizes) at
   n=2^13, L=8 (poly, BGG+ encoding d=1 and d=2, packed 4 slots, naive vec 4
   slots, each encoding model with its LWE online lookup as the PubLut
   cost; preimages d=1, d=2 and the FE's 1-column d=2, one masked decode)
   and at the Diamond iO ring (preimage d=2, naive vec 4 slots); the
   estimates of phases 8, 9, 12 and 17 beside the times
   those phases measured above, with their ratio; the estimated injector and
   decoder preimage counts beside the preimages the runs made (checked
   equal), the estimated artifact bytes beside the bytes written; the AKY24
   iO estimate (tests/test_aky24_io.py's circuit and IO_KW) and its CRT-depth
   search at n=2^13, crt_bits 28, base_bits 14 (checked: a depth is found
   and simulates ok); every cost checked finite and positive, K1/K2
   launched;
19. `core ops` at n=2^13, L=8, crt_bits 28, base_bits 14: `mul_decompose`
   of a [2, 32] by a [2, 512] matrix with G^-1 whole and in column chunks of
   64 (MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH; times and peaks of both), G
   G^-1(B) == B, the small gadget and decomposition, the tensor-identity
   products against the materialized I_4 x other, `concat_diag`, the
   hash-decomposed samplers against the decompositions of `sample_hash`, the
   Poly round trips (EVAL slots, base digits, threshold bits), packed bytes
   of an [18, 16] matrix (the LWE chain's K_high shape; ratio and GB/s of
   pack and unpack) and .mxxp/.mxxm files, all exact;
20. `ckks`: one CKKS mul + relinearize + rescale at the same ring (p-moduli
   below 2^8, scale 2^24, one relinearization level): the circuit built,
   saved with `save_circuit`, loaded with `load_circuit` (JSON round trip
   equal), and the loaded circuit evaluated over constant polys on the card
   through `eval_batched` (the JAX tests' mode); checked: the decrypted
   product and the rescaled product within 0.1 of m1 m2; the BGG+ sizing
   that keeps it off BGG+ wires, projected from phase 10's measured pass;
21. `montgomery`: one Montgomery multiplication mod 64513 (4 limbs of 4
   bits) over BGG+ public keys and encodings lifted from the one wire, as in
   phase 10: inputs the Montgomery forms of x and y, the output converts
   back to x y mod N, plaintexts == oracle, encoding pubkeys == pubkey pass,
   c == s A - pt (s G), all exact;
22. `ntt circuit`: `forward_ntt` then `inverse_ntt` over 8 packed slots mod
   17 at n=2^13 over `PolyVec` plaintexts on the card: the forward output
   equals the host NTT mod 17 and the round trip the input; K1 and K2
   launched in each of phases 19-22 (counters reset before, read after);
23. `diamond io lwe`: Diamond iO over the production LWE LUT evaluators
   (the default factories), the config of tests/test_production_lwe_diamond.py
   (n=4, L=3, crt_bits 10, base_bits 10, input_count 1, batch_bits 1, seed
   11, its PRF config with nested_rns_scale 64, debug replay, the builder
   [bits[0]]; the ring is cut by artifact size: the phase prints the K_high
   bytes its row count projects at n=2^12, L=2 and n=2^13, L=8): obfuscate
   into a temporary directory (the LUT bridge preimage; the K_high rows of
   every recorded LUT gate, assembled and sampled in shared preimage calls,
   written through the store), evaluate [0] and [1] (c_b = s B; K_high read
   back); checked: both decode, c_one == sigma (A_one - G), B0 lut_bridge
   == [lut_b; 0], B K_high == target for every stored row of the first LUT
   gate of each plt context (refresh decrypts, wrapped circuit), all exact;
   times by span (bridge, targets, preimages, copies, writes, online
   reads), preimage calls and columns, files and bytes, peak device memory
   and host RSS;
24. `diamond io noise`: packed payload (4 slots) at n=256, L=3, crt_bits 24,
   base_bits 5, error sigma 4.0 everywhere, trapdoor sigma 4.578, seed
   6042, the CI PRF config, debug LUT evaluators, XOR of two bits
   (tests/test_noise_regime.py `test_diamond_io_packed_noise_n256`);
   checked: both decode, and the worst observed error in bits <= the
   composed simulated bound (replay mode) <= observed + 80, printed side by
   side; the decode margins are printed against (q // 4) >> 4, not held (the
   error is q-scale in both packages); times by span and peak device
   memory. Phases 23 and 24 launch neither K1 nor K2 (n < 2048): phase
   24's forward transforms go through K3 (ring/ntt.py routes 256 <= n < 2048
   there), which it requires; phase 23's ring (n=4) takes the radix chain
   both ways;
25. `mesh`: `parallel/` on the card. It prints the device count and the
   shards of `make_mesh()` (one per card: 1x1 on a one-card machine) and of
   two logical meshes whose shards all sit on the card (1x4 and 2x4); then
   (i) `preimage_batched_sharded` at phase 4's ring and seeds over requests
   of 17 / 17 / 16 columns: through `make_mesh()` equal bit for bit to the
   unsharded call of a sampler with the same seed; through the 1x4 mesh (50
   -> 52 columns) A x == U per request and each shard equal bit for bit to
   `_preimage_core` under the call's key folded with its index, K1/K2
   launched (counters reset before the call, read after); the median of 3
   of each beside the unsharded call; (ii) over the 2x4 mesh at n=2^13,
   L=8: the limb + column sharded `zq_matmul` of [2, 4] x [4, 8] and the
   limb-sharded `ntt_fwd` of [8, 64, 8192] equal the unsharded results
   (radix chain and K1) bit for bit; (iii) `crt_switch_sharded` of a
   [2, 512] COEFF matrix there for P = 2, 251, 2^16: equal to
   `PolyMatrix.modulus_switch(P)` everywhere and to the exact big-int rule
   on 4,096 sampled coefficients, ms per call beside `modulus_switch`, and
   the count of coefficients that independent per-shard float64 partials
   would round otherwise; (iv) a mesh of two distinct devices, the card
   and the host: at n=2^13, L=8 a 1x2 (card, host) preimage of requests
   of 3 / 2 columns holds A x == U per request, comes back to the card,
   and each shard equals `_preimage_core` run on its own device, bit for
   bit; `crt_switch_sharded` over 2x1 (card, host) and (host, card) equals
   `modulus_switch` for the three P; (v) phase 7's LWE chain with its
   K_high preimages over the 1x4 mesh, every check of phase 7, its times
   beside phase 7's;
26. `diamond io real`: real-mode Diamond iO at the config of the JAX
   package's `test_diamond_io_real_mode_e2e` (n=2, L=2, crt_bits 9,
   base_bits 9, seed_bits 5, wide p-basis below 2^8, max_unreduced_muls 2,
   no debug flag, every wire refreshed, PRG-derived refresh material,
   input_count 1, batch_bits 1, seed 7, error sigma 0, trapdoor sigma
   4.578, debug LUT evaluators, builder [bits[0]]): obfuscate into a
   temporary directory, evaluate [0] and [1], delete it; checked: both
   decode, no PRG ciphertext in the obfuscation, c_one == sigma (A_one -
   G), B0 P == target for every rebase and refresh preimage of branch 0
   (targets captured at the calls), the online PRG wires' public keys equal
   the offline pass's of the selected branch, all exact; printed: gate and
   level counts of each branch's PRG round circuit, of the refresh-material
   circuits and of the wrapped circuit, times by span (PRG round and
   material builds and passes, targets, preimages, writes, reads, wrapped
   passes), gates/s per pass, preimage calls and columns, files and bytes,
   peak device memory and host RSS, and the K1/K2/K3 launches (none: n=2
   takes the radix chain both ways);
27. `production ring`: the main path at the production depth of the
   security-100 table (L=53, crt_bits 28, base_bits 14, k = 106 digits, d=1,
   sigma 4.578), through `mxx_tpu_torch/scripts/security100_parameter_table.py`
   `measure_preimage` (a warm-up and two timed calls, B x == U checked after
   each): the table's anchors, 8 columns at n=2^13 and n=2^14, then the
   preimage directly at n=2^16 over 2 columns, and over 4 if the 2-column
   run's peak, scaled, stays under 60 GiB; each ring with the K1/K2/K3
   counters reset before it and read after it (K1 and K2 required at 2^13
   and 2^14, K3 at 2^16), its cols/s and peak device memory printed, the
   direct run's cols/s beside the value extrapolated from the anchors; then
   the table's rows from the measured anchors, printed and written to
   `build/mxx_tpu_torch/security_bits_100_diamond_io_parameters.csv`;
28. timings (CUDA events, a warm-up, the median of a few runs): forward NTT
   at shape A (K1, K3, radix chain) and K2 there, preimage-cols/s, a profiled
   preimage, its device time split by stage, GSW ext-prods/s at n=2^13, L=8,
   B=64, the two batched BGG passes, and a profiled batched encoding pass,
   its device time split by stage; then `ntt_fwd_auto` at the production ring
   [10, 250, 65536] (routed to K3, counted, equal to the chain) beside the
   radix chain, and `ntt_inv_auto` (the radix chain) at [10, 500, 32768] and
   [10, 250, 65536]; each kernel against its plain version and the radix chain
   (and K1 at 2^14): K1, K2 and K3's head and whole transform at the largest
   transform of the preimage ([10, 1000, 16384]), K3's whole transform at
   [10, 500, 32768], [10, 250, 65536] and [3, 4096, 256]; and K1 against K3
   in turns (K1, K3, K3, K1) at [10, 1000, 16384] and [8, 512, 8192], with
   the routing of 2048 <= n <= 16384 they support beside ring/ntt.py's; and at
   the production depth, K1 and K2 at [53, 848, 16384] (the anchor
   preimage's largest transform) and K3's whole transform at
   [53, 212, 65536] (the direct 2-column preimage's);
29. one JSON line of kernels (`launches` from one path: the LWE LUT chain
   for K1/K2, the diamond io noise phase for K3's whole transform, K3's own
   path for its head, the production ring phase for the L=53 rows; each
   path's count beside it in `launches_by_path`;
   each row's least time `bound_ms`, the larger of its device-memory time
   and its integer floor, and its share `pct_of_bound`; beside it
   `bound_ms_u32`, the same bound for the TPU kernel's uint32 layout, 8
   bytes per residue; `chain_ms`, the radix chain's time; `library_ms`
   null, since no PyTorch call computes an exact NTT mod q), and the
   ChaCha20 kernel's rows: `_keystream_words` through the kernel against
   its plain twin on the card, bit for bit, at a bench-ring and a
   security-100 preimage call's keystream (3,174,400 and 2,621,440 blocks,
   one launch each), its time per launch back to back and for one call, the
   twin's, and its bound, the larger of its int64 stores and the issue floor
   of its SASS (`CHACHA_SASS`; `library_ms` null, since no PyTorch call
   computes ChaCha20; `launches` the main path's), then the result line.
"""

import json
import math
import os
import resource
import statistics
import subprocess
import sys
import threading
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
    """The bound of the port's int64 layout, and beside it the bound of the
    TPU kernel's uint32 layout (8 bytes per residue read and written)."""
    polys = math.prod(shape[:-1])
    bytes_ms = 16 * polys * shape[-1] / HBM_BYTES_PER_S * 1e3
    bytes_u32_ms = bytes_ms / 2
    int_ms = polys * products * INSTR_PER_PRODUCT / INT32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, int_ms), "bound_by": "bytes" if bytes_ms >= int_ms
            else "operations", "bytes_ms": bytes_ms, "int_floor_ms": int_ms,
            "bound_ms_u32": max(bytes_u32_ms, int_ms), "bytes_ms_u32": bytes_u32_ms,
            "bound_by_u32": "bytes" if bytes_u32_ms >= int_ms else "operations"}


def build_kernels(modules) -> None:
    """One compiler per source (nvcc for a kernel, g++ for host code), all
    started together; ptxas lines printed."""
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
    reset_launches()
    results = [(hybrid_ntt.ntt_fwd_head(x, p), hybrid_ntt.ntt_fwd_hybrid(x, p))
               for _, p, x in inputs]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"radix path: launches head {counts['head']}, hybrid {counts['hybrid']}", flush=True)
    worst = 0
    for (label, p, x), (head, full) in zip(inputs, results):
        t = p.tables(dev)
        errs = {
            "head==head_plain": max_err(head, hybrid_ntt.ntt_fwd_head_plain(x, p)),
            "hybrid==chain": max_err(full, ntt.ntt_fwd(x, t.psi_rev, t.moduli)),
            "hybrid==hybrid_plain[:8]": max_err(full[:, :8],
                                                hybrid_ntt.ntt_fwd_hybrid_plain(x[:, :8], p)),
        }
        if 2048 <= p.n <= 16384:
            errs["hybrid==K1"] = max_err(full, four_step.four_step_ntt_fwd(x, p, p.n // 128))
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
    from mxx_tpu_torch.ring.poly import Poly

    c, pks, encs, plain, es = bgg_circuit(p, dev)
    torch.cuda.synchronize()
    reset_launches()
    seq_pk = c.eval(p, pks[0], pks[1:])
    bat_pk = eval_batched(c, p, pks[0], pks[1:])
    seq_enc = c.eval(p, encs[0], encs[1:])
    bat_enc = eval_batched(c, p, encs[0], encs[1:])
    torch.cuda.synchronize()
    counts = launch_counts()
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
    ("mxx_tpu_torch/lookup/", "lookup (other)"),
    ("mxx_tpu_torch/bgg/", "bgg wires (other)"),
    ("mxx_tpu_torch/circuit/batched_eval.py", "batched_eval stacking"),
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


class SpanLog:
    """The port's spans and events over a phase: a thin reader of
    `utils/tracing.py`'s `recording()`. A span's `ms` includes the device work
    it queued (its CUDA events, read when the recording closes)."""

    def __enter__(self):
        from mxx_tpu_torch.utils import tracing

        self._recording = tracing.recording()
        self.rec = self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        return self._recording.__exit__(*exc)

    @property
    def records(self) -> list:
        return self.rec.spans

    def named(self, name) -> list:
        return self.rec.named(name)

    def total_ms(self, name) -> float:
        return sum(r.ms for r in self.rec.named(name))

    def events(self, name) -> list[dict]:
        return [e.fields for e in self.rec.events if e.name == name]


def drive_lwe_lut(p, dev, timing, mesh=None, label="lwe lut chain") -> tuple[dict, dict]:
    """The LWE public-LUT chain of scripts/realistic_scale_run.py on the
    port: plaintext oracle, offline pubkey pass, K_high sampling and writes
    (`sample_aux_matrices`, `wait_for_all_writes`; K_high's preimages over
    `mesh` if given), online encoding pass and the masked-rounding decode;
    then every stored K_high row is read back (each batch part once) and
    held to B K_high == target exactly. Returns the K1/K2 launch counts of
    the chain and its sub-phase times (ms)."""
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
    from mxx_tpu_torch.native import writer
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
        print(f"{label}: K_high artifacts {n_luts} gates x {entries} rows x "
              f"{row_bytes} B = {want_bytes} B to {tmp}; free there {free} B", flush=True)
        if free < 2 * want_bytes:
            raise SystemExit(f"chip_smoke: {tmp} has {free} B free, under twice the "
                             f"{want_bytes} B of K_high artifacts the {label} writes")
        init_storage_system(tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ms = {}

        def clock(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return out

        pt = clock("plaintext oracle", lambda: circuit.eval(
            p, Poly.one(p, dev), plaintexts, plt_evaluator=PolyPltEvaluator())[0])
        pk_eval = LWEBGGPubKeyPltEvaluator(BGG_KEY, trap, b0, td, tmp, mesh=mesh)
        out_pk = clock("pubkey pass", lambda: circuit.eval(
            p, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0])
        states = dict(pk_eval.gate_state)
        with SpanLog() as spans, HostRssPeak() as rss:
            clock("sample_aux_matrices", lambda: pk_eval.sample_aux_matrices(p))
            held = writer.held_files()
            clock("wait_for_all_writes", wait_for_all_writes)
        host_note = offline_host_note(rss, held, len(spans.events("storage.write_part")))
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
        counts = launch_counts()
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
    print(f"{label} n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits "
          f"{p.base_bits} d=1 p={P_MOD}, {entries}-entry LUT, {circuit.gate_counts()}: "
          f"plaintext == oracle {ok_oracle}, A_LT online == offline {ok_alt}, "
          f"B K_high == target for {rows - len(bad)} of {n_luts * entries} stored rows "
          f"{ok_rows} (tolerance 0: exact), decode {ok_decode} (error {err} = 2^{err_bits:.2f} "
          f"under the q/(2p) budget {budget} = 2^{math.log2(budget):.2f}); launches in the "
          f"chain: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    if not all((ok_oracle, ok_alt, ok_rows, ok_decode)):
        raise SystemExit(f"chip_smoke: {label} check failed (bad rows {bad[:5]})")

    cols = sum(r.fields["cols"] for r in spans.named("lwe_lut.k_high_preimages"))
    writes = spans.events("storage.write_part")
    pre_ms = ms["K_high preimages"] = spans.total_ms("lwe_lut.k_high_preimages")
    d2h_ms = spans.total_ms("storage.device_to_host")
    ser_ms = spans.total_ms("storage.serialize")
    for name in ("plaintext oracle", "pubkey pass"):
        timing(f"{label}: {name}", ms[name], "ms")
    timing(f"{label}: sample_aux_matrices", ms["sample_aux_matrices"], "ms",
           f" ({n_luts} gates)")
    timing(f"{label}: target assembly", spans.total_ms("lwe_lut.k_high_targets"), "ms",
           f" ({n_luts * entries} targets)")
    timing(f"{label}: K_high preimages", cols / pre_ms * 1e3, "preimage-cols/s",
           f" ({pre_ms:.1f} ms for {cols} cols)")
    timing(f"{label}: device-to-host copy + serialize", d2h_ms + ser_ms, "ms",
           f" ({want_bytes / (d2h_ms + ser_ms) / 1e6:.3f} GB/s; copy {d2h_ms:.1f} ms, "
           f"{want_bytes / d2h_ms / 1e6:.3f} GB/s; serialize {ser_ms:.1f} ms, "
           f"{want_bytes / ser_ms / 1e6:.3f} GB/s)")
    timing(f"{label}: wait_for_all_writes (the native writer's barrier)",
           ms["wait_for_all_writes"], "ms",
           f" ({written} B in {parts} batch files, {len(writes)} queued to the C++ writer "
           f"without a copy; {host_note})")
    timing(f"{label}: encoding pass", ms["encoding pass"], "ms")
    timing(f"{label}: decode", ms["decode"], "ms")
    print(f"{label}: bytes written {written} (reckoned {want_bytes} of payloads)",
          flush=True)
    timing(f"{label}: peak device memory", peak / 1e9, "GB")
    require_launches(label, counts)
    return counts, ms


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


def we_encryption(p, dev, msg: bool, check_states: bool, timing) -> tuple[bool, dict]:
    """One Diamond WE encryption of `msg` through `enc` and `dec` with the
    witness [False, True], in its own temporary directory (deleted when its
    checks are done); with `check_states`, every final injector state is
    held to its simulated error bound. Prints its checks and times and
    returns whether they held, with what the estimators phase compares
    (`enc` and `dec` ms, the transition preimages made, the injector and the
    circuit)."""
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
        targets = []  # transition preimages (targets) per call
        instrument(injector._trap, "preimage_batched_chunked", log, "transition preimages",
                   lambda a, out: peaks.append(torch.cuda.max_memory_allocated())
                   or targets.append(len(a[3])) or sum(t.ncol for t in a[3]))
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
    return ok, {"enc_ms": enc_ms, "dec_ms": dec_ms, "transition_preimages": sum(targets),
                "injector": injector, "circuit": circuit}


def drive_diamond_we(p, dev, timing) -> dict:
    """Diamond WE: one encryption of each message, each with a fresh
    injector, the first one's final states held to their bounds. Returns
    the K1/K2 launch counts of the phase ("launches") and each encryption's
    measurements ("runs")."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing("diamond we: device memory allocated at the start",
           torch.cuda.memory_allocated() / 1e9, "GB")
    reset_launches()
    ok, runs = zip(*(we_encryption(p, dev, msg, not msg, timing) for msg in (False, True)))
    torch.cuda.synchronize()
    counts = launch_counts()
    timing("diamond we: peak device memory", torch.cuda.max_memory_allocated() / 1e9, "GB")
    print(f"diamond we: launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}",
          flush=True)
    if not all(ok):
        raise SystemExit("chip_smoke: Diamond WE check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the Diamond WE phase did not go through both four-step "
                         "kernels")
    return {"launches": counts, "runs": runs}


def drive_aky24_fe(p, dev, timing) -> dict:
    """AKY24 FE through setup, keygen, enc and dec of four messages, checked
    against f(x) and the exact K_f relation. Returns the K1/K2 launch counts
    of the phase ("launches"), the median ms of each call and the circuit."""
    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.func_enc import Aky24FuncEnc

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

    reset_launches()
    _, msk = clock("setup", lambda: fe.setup(p))
    fsk = clock("keygen", lambda: fe.keygen(p, msk, c))
    got = []
    for m in msgs:
        ct = clock("enc", lambda m=m: fe.enc(p, msk, m))
        got.append(clock("dec", lambda ct=ct: fe.dec(p, ct, fsk, c)))
    torch.cuda.synchronize()
    counts = launch_counts()
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
    return {"launches": counts, "ms": {k: statistics.median(v) for k, v in ms.items()},
            "circuit": c}


def timed(fn):
    """(fn(), milliseconds), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# the tracer's kernel-launch counters, under this script's names
LAUNCH_COUNTERS = {"fwd": "ntt.k1", "inv": "ntt.k2", "head": "ntt.k3_head",
                   "hybrid": "ntt.k3_whole", "chacha": "chacha.kernel_launches"}
_launch_base: dict = {}


def reset_launches() -> None:
    """Start counting K1/K2 (four_step), K3 (hybrid_ntt) and ChaCha20
    (sampler/chacha.py) launches anew."""
    from mxx_tpu_torch.utils import tracing

    _launch_base.clear()
    _launch_base.update(tracing.counters())


def launch_counts() -> dict:
    """Launches since reset_launches, from the tracer's counters: K1 "fwd",
    K2 "inv", K3 "head" and "hybrid" (ring/ntt.py routes forward transforms
    of 256 <= n < 2048 and 16384 < n <= 65536 on the card to K3's "hybrid"),
    and the ChaCha20 kernel "chacha"."""
    from mxx_tpu_torch.utils import tracing

    now = tracing.counters()
    return {key: now[c] - _launch_base.get(c, 0) for key, c in LAUNCH_COUNTERS.items()}


def require_launches(phase: str, counts: dict) -> None:
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit(f"chip_smoke: the {phase} phase did not go through both four-step "
                         "kernels")


def lifted_passes(p, dev, circuit, values, tag: bytes, seed: int) -> dict:
    """`circuit` over BGG+ public keys and encodings (d=1, error sigma 4.0)
    whose inputs are the constants `values` lifted from the one wire by
    `lift_constants_batched`, both passes through `eval_batched` with the
    debug LUT evaluators, then the plaintext oracle over constant polys.
    The K1/K2 launch counters are reset before the lifts and read after the
    passes. Checks (exact): lifts == per-call `large_scalar_mul` on a
    sample, lifted wires on the card, plaintexts == oracle, encoding pubkeys
    == pubkey pass, c == s A - pt (s G) for every output."""
    import torch

    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.bgg.lift import lift_constants_batched
    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.lookup import (
        DebugBGGEncodingPltEvaluator,
        DebugBGGPubKeyPltEvaluator,
        PolyPltEvaluator,
    )
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, UniformSampler

    secret = UniformSampler(seed=seed, device=dev).sample_poly(p, TernaryDist())
    one_pk = BGGPublicKeySampler(BGG_KEY, 1, device=dev).sample(p, tag, [])
    es = BGGEncodingSampler(p, [secret], gauss_sigma=4.0, seed=seed + 1)
    one_enc = es.sample(p, one_pk, [])[0]
    s = es.secret_vec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pk_in, ms_lift_pk = timed(lambda: lift_constants_batched(p, one_pk[0], values))
    enc_in, ms_lift_enc = timed(lambda: lift_constants_batched(p, one_enc, values))
    sample = [0, len(values) // 2 - 1, len(values) - 1]
    ok_lift = all(pk_in[i] == one_pk[0].large_scalar_mul(p, [values[i]])
                  and enc_in[i] == one_enc.large_scalar_mul(p, [values[i]]) for i in sample)
    ok_lift_card = all(w.vector.data.is_cuda and w.pubkey.matrix.data.is_cuda for w in enc_in)
    stores: list = []
    pk_out, ms_pk = timed(lambda: eval_batched(
        circuit, p, one_pk[0], pk_in, DebugBGGPubKeyPltEvaluator(BGG_KEY), wire_store_out=stores))
    enc_out, ms_enc = timed(lambda: eval_batched(
        circuit, p, one_enc, enc_in, DebugBGGEncodingPltEvaluator(BGG_KEY, s),
        wire_store_out=stores))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del enc_in

    oracle, ms_oracle = timed(lambda: circuit.eval(
        p, Poly.one(p, dev), [Poly.const(p, v, dev) for v in values],
        plt_evaluator=PolyPltEvaluator()))
    s_g = s @ PolyMatrix.gadget_matrix(p, 1, dev)
    ok_oracle = all(e.plaintext == o for e, o in zip(enc_out, oracle))
    ok_keys = all(e.pubkey == k_ for e, k_ in zip(enc_out, pk_out))
    ok_rel = all(e.vector == s @ e.pubkey.matrix - s_g.mul_poly_scalar(o)
                 for e, o in zip(enc_out, oracle))
    torch.cuda.synchronize()
    return dict(one_pk=one_pk[0], pk_in=pk_in, pk_out=pk_out, enc_out=enc_out, oracle=oracle,
                counts=counts, peak=peak, stores=stores, sample=sample, ok_lift=ok_lift,
                ok_lift_card=ok_lift_card, ok_oracle=ok_oracle, ok_keys=ok_keys, ok_rel=ok_rel,
                ms_lift_pk=ms_lift_pk, ms_lift_enc=ms_lift_enc, ms_pk=ms_pk, ms_enc=ms_enc,
                ms_oracle=ms_oracle)


def drive_nested_rns_mul(p, dev, timing, record: dict | None = None) -> dict:
    """One nested-RNS modular multiplication (the unit every RingGSW external
    product is made of) over BGG+ public keys and encodings whose inputs are
    lifted from the one wire. Returns the K1/K2 launch counts of the phase;
    `record` receives the passes' times and gate counts."""
    import random

    from mxx_tpu_torch.bgg.lift import lift_chunk_size
    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.gadgets.arith.nested_rns import (
        NestedRnsPoly,
        decode_nested_rns_outputs,
        encode_nested_rns_value,
    )
    from mxx_tpu_torch.gadgets.fhe import RingGswContext
    from mxx_tpu_torch.lookup import DebugBGGPubKeyPltEvaluator

    circuit = PolyCircuit()
    ctx = RingGswContext(circuit, p, 8, 2, p_basis="wide").nested
    a = NestedRnsPoly.input(ctx, circuit)
    b = NestedRnsPoly.input(ctx, circuit)
    prod = a.mul(b, circuit).full_reduce(circuit)
    circuit.output(prod.flatten() + [prod.reconstruct(circuit)])
    counts_by_kind = circuit.gate_counts()
    n_gates = sum(v for g, v in counts_by_kind.items() if g != "Input")
    n_lut = counts_by_kind.get("PubLut", 0)

    rng = random.Random(61)
    q_big = p.modulus
    x, y = rng.randrange(q_big), rng.randrange(q_big)
    values = [r for v in (x, y) for row in encode_nested_rns_value(ctx, v) for r in row]
    run = lifted_passes(p, dev, circuit, values, b"nested_rns", 62)
    enc_out, counts, sample = run["enc_out"], run["counts"], run["sample"]
    k, levels = ctx.k, prod.levels
    raw = [e.plaintext.const_value() for e in enc_out]
    rows = [raw[lvl * k:(lvl + 1) * k] for lvl in range(levels)]
    want = x * y % q_big
    ok_decode = decode_nested_rns_outputs(ctx, rows) == want and raw[-1] == want
    ok_shape = len(enc_out) == levels * k + 1 and all(
        e.vector.data.shape == (p.crt_depth, 1, p.modulus_digits, p.n) for e in enc_out)
    checks = [run[c] for c in ("ok_lift", "ok_lift_card", "ok_oracle", "ok_keys", "ok_rel")]
    ms_pk, ms_enc = run["ms_pk"], run["ms_enc"]
    print(f"nested rns mul n={p.n} L={p.crt_depth} d=1, wide p-basis of {k} moduli below 2^8, "
          f"{len(values)} lifted inputs, {n_gates} gates ({n_lut} PubLut), {len(enc_out)} "
          f"outputs: lifts == large_scalar_mul on wires {sample} {checks[0]}, lifted wires on "
          f"the card {checks[1]}, outputs decode to x y mod Q {ok_decode}, plaintexts == oracle "
          f"{checks[2]}, encoding pubkeys == pubkey pass {checks[3]}, c == s A - pt (s G) "
          f"{checks[4]}, shapes {ok_shape} (tolerance 0: exact); lift chunks of "
          f"{lift_chunk_size(p, 1, False)} (pubkeys) and {lift_chunk_size(p, 1, True)} "
          f"(encodings) constants; live wires at most "
          f"{max(st.peak_live_bytes for st in run['stores']) / 2**30:.2f} GiB, "
          f"{sum(st.spill_count for st in run['stores'])} spilled; launches in the phase: fwd "
          f"{counts['fwd']}, inv {counts['inv']}", flush=True)
    timing("nested rns mul: lift onto public keys", len(values) / run["ms_lift_pk"] * 1e3,
           "constants/s", f" ({run['ms_lift_pk']:.1f} ms for {len(values)})")
    timing("nested rns mul: lift onto encodings", len(values) / run["ms_lift_enc"] * 1e3,
           "constants/s", f" ({run['ms_lift_enc']:.1f} ms for {len(values)})")
    timing(f"nested rns mul: pubkey pass, batched, {n_gates} gates", n_gates / ms_pk * 1e3,
           "gates/s", f" ({ms_pk:.1f} ms)")
    timing(f"nested rns mul: encoding pass, batched, {n_gates} gates", n_gates / ms_enc * 1e3,
           "gates/s", f" ({ms_enc:.1f} ms)")
    timing("nested rns mul: plaintext oracle, sequential", run["ms_oracle"], "ms")
    timing("nested rns mul: peak device memory of lifts and passes", run["peak"] / 2**30, "GiB")
    if not all(checks + [ok_decode, ok_shape]):
        raise SystemExit("chip_smoke: nested-RNS multiplication check failed")
    require_launches("nested rns mul", counts)
    if record is not None:
        record.update(ms_pk=ms_pk, ms_enc=ms_enc, gates=n_gates, luts=n_lut)
    one_pk, pk_in = run["one_pk"], run["pk_in"]
    del run, enc_out
    profiled_stages("nested rns mul: pubkey pass, batched, profiled",
                    lambda: eval_batched(circuit, p, one_pk, pk_in,
                                         DebugBGGPubKeyPltEvaluator(BGG_KEY)), timing)
    return counts


class CheckedPreimages:
    """A trapdoor sampler that times each preimage call (the card
    synchronized around it) and holds B P == target for it at once, so no
    target or preimage is kept."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: list = []  # (ms, target columns, B P == target)

    def preimage(self, params, trapdoor, public_matrix, target):
        out, ms = timed(lambda: self.inner.preimage(params, trapdoor, public_matrix, target))
        self.calls.append((ms, target.ncol, public_matrix @ out == target))
        return out

    def take(self):
        calls, self.calls = self.calls, []
        return (sum(c[0] for c in calls), sum(c[1] for c in calls), len(calls),
                all(c[2] for c in calls))


def trapdoor_state(p, dev):
    """(checked sampler, trapdoor, B0, sigma, state0 = [sigma, 1] B0) of the
    refresh and decoder phases."""
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, TrapdoorSampler, UniformSampler

    ts = CheckedPreimages(TrapdoorSampler(p, 4.578, seed=141, device=dev))
    td0, b0 = ts.inner.trapdoor(p, 2)
    sigma = UniformSampler(seed=142, device=dev).sample_poly(p, TernaryDist())
    state0 = PolyMatrix.from_poly_row(p, [sigma, Poly.const(p, 1, dev)]) @ b0
    return ts, td0, b0, sigma, state0


def small_error(p, ncol: int, dev, value: int, every_entry: bool):
    """1 x ncol COEFF matrix with `value` in coefficient 0 of every entry
    (or of the first entry only)."""
    import torch

    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import COEFF

    data = torch.zeros((p.crt_depth, 1, ncol, p.n), dtype=torch.int64, device=dev)
    data[:, :, slice(None) if every_entry else 0, 0] = value
    return PolyMatrix(data, COEFF, p)


def drive_noise_refresh(p, dev, state, timing) -> dict:
    """The Diamond noise refresher on one wire, then the CRT-level-split
    refresher over every level. Returns the K1/K2 launch counts."""
    import random

    import torch

    from mxx_tpu_torch.bgg import BggEncoding, BggPublicKey
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.noise_refresh.refresh import (
        DiamondNoiseRefresher,
        NoiseRefresherNaiveVec,
    )
    from mxx_tpu_torch.ring.poly import Poly

    ts, td0, b0, sigma, state0 = state
    q = p.modulus
    g = PolyMatrix.gadget_matrix(p, 1, dev)
    torch.cuda.synchronize()
    reset_launches()

    # (i) one wire
    nr = DiamondNoiseRefresher(p, ts, b0, td0, BGG_KEY, 1, 8, base_bits=4)
    x = nr.delta * random.Random(143).randrange(1, q // nr.delta - 1)
    a_c = nr._hash_pk("wire_a_c")
    clean = state0 @ nr._abs_encoding_preimage(a_c, x)
    dirty = BggEncoding(clean + small_error(p, clean.ncol, dev, 7, True),
                        BggPublicKey(a_c, False), None)
    ts.take()
    material, _ = timed(lambda: nr.preprocess(b"refresh0", a_c))
    pre_ms, pre_cols, pre_calls, ok_pre = ts.take()
    refreshed, ms_online = timed(lambda: nr.online_eval(b"refresh0", state0, dirty, material))
    x_g = g.mul_poly_scalar(Poly.const(p, x, dev))
    ok_fresh = refreshed.vector == refreshed.pubkey.matrix.mul_poly_scalar(sigma) - x_g
    ok_dirty = not (dirty.vector == a_c.mul_poly_scalar(sigma) - x_g)
    ok_card = refreshed.vector.data.is_cuda and all(
        m.data.is_cuda for m in (material["p_mask"], material["p_decoder"], material["a_m"]))
    mid = launch_counts()
    print(f"noise refresh (i) n={p.n} L={p.crt_depth}, DiamondNoiseRefresher v_bits 8, base_bits "
          f"4, Delta 2^{nr.delta.bit_length() - 1}, {nr.num_digits} digits: {pre_calls} "
          f"preimages of {pre_cols} target columns, B0 P == target {ok_pre}; refreshed == "
          f"sigma A' - x G {ok_fresh}, the dirty wire did not satisfy it {ok_dirty} "
          f"(tolerance 0: exact), on the card {ok_card}; launches so far: fwd {mid['fwd']}, "
          f"inv {mid['inv']}", flush=True)
    timing("noise refresh (i): preprocess", pre_cols / pre_ms * 1e3, "preimage-cols/s",
           f" ({pre_ms / 1e3:.3f} s in {pre_calls} preimage calls, {pre_cols} columns)")
    timing("noise refresh (i): online_eval", ms_online, "ms")
    del material, refreshed, dirty, clean

    # (ii) every CRT level
    nv = NoiseRefresherNaiveVec(p, ts, b0, td0, BGG_KEY, 1, 6, base_bits=4)
    rng = random.Random(153)
    xv = rng.randrange(q)
    ys = nv.encode_values(xv)
    ok_twist = sum(yi * (q // q_i) for yi, q_i in zip(ys, p.moduli)) % q == xv
    a_cs, encs = [], []
    for i, (lvl, yi) in enumerate(zip(nv.levels, ys)):
        a_ci = lvl._hash_pk(f"nv_wire_{i}")
        clean = state0 @ lvl._abs_encoding_preimage(a_ci, yi)
        a_cs.append(a_ci)
        encs.append(BggEncoding(clean + small_error(p, clean.ncol, dev, 1, False),
                                BggPublicKey(a_ci, False), None))
    ts.take()
    materials, _ = timed(lambda: nv.preprocess(b"nv", a_cs, rng))
    pre_ms, pre_cols, pre_calls, ok_pre_v = ts.take()
    (fresh, recomposed, x_hat), ms_online_v = timed(
        lambda: nv.online_eval(b"nv", state0, encs, materials))
    ok_exact = recomposed.vector == recomposed.pubkey.matrix.mul_poly_scalar(sigma) - \
        g.mul_poly_scalar(Poly.const(p, x_hat, dev))
    bound = sum((lvl.delta // 2 + 1) * (q // q_i) for lvl, q_i in zip(nv.levels, p.moduli))
    diff = min((x_hat - xv) % q, (xv - x_hat) % q)
    ok_bound = diff <= bound
    per_level = nv.levels[0].num_digits + 2  # the mask, each digit, the decoder (one column)
    ok_counts = (pre_calls, pre_cols, len(fresh)) == (
        per_level * p.crt_depth, ((per_level - 1) * p.modulus_digits + 1) * p.crt_depth,
        p.crt_depth)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"noise refresh (ii) NoiseRefresherNaiveVec v_bits 6, base_bits 4 over "
          f"{p.crt_depth} levels: twisted residues recompose {ok_twist}, {pre_calls} preimages "
          f"of {pre_cols} target columns {ok_counts}, B0 P == target {ok_pre_v}; recomposed == "
          f"sigma A' - x_hat G {ok_exact} (tolerance 0: exact), |x_hat - x| = "
          f"2^{math.log2(max(diff, 1)):.2f} <= bound 2^{math.log2(bound):.2f} {ok_bound}; "
          f"launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    timing("noise refresh (ii): preprocess", pre_cols / pre_ms * 1e3, "preimage-cols/s",
           f" ({pre_ms / 1e3:.3f} s in {pre_calls} preimage calls, {pre_cols} columns)")
    timing("noise refresh (ii): online_eval", ms_online_v, "ms",
           f" ({p.crt_depth} levels)")
    if not all((ok_pre, ok_fresh, ok_dirty, ok_card, ok_twist, ok_pre_v, ok_exact, ok_bound,
                ok_counts)):
        raise SystemExit("chip_smoke: noise refresh check failed")
    require_launches("noise refresh", counts)
    return counts


def drive_masked_decode(p, dev, state, timing) -> dict:
    """The masked high-bit decoder: four stored preimages, four bits decoded.
    Returns the K1/K2 launch counts ("launches") and the ms of `online_decode`
    with its output count."""
    import random
    import tempfile
    from types import SimpleNamespace

    import torch

    from mxx_tpu_torch.bgg import BggEncoding, BggPublicKey
    from mxx_tpu_torch.decoder import DirectoryDecoderArtifacts, MaskedHighBitDecoder
    from mxx_tpu_torch.decoder import masked_high_bit
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import FinRingDist, HashSampler

    ts, td0, b0, sigma, state0 = state
    q = p.modulus
    rng = random.Random(12)
    bits = [1, 0, 1, 1]
    masks = [rng.randrange(-(q // 4) + 1, q // 4) for _ in bits]
    g = PolyMatrix.gadget_matrix(p, 1, dev)
    hs = HashSampler(dev)
    torch.cuda.synchronize()
    reset_launches()
    pks, outputs = [], []
    for i, (bit, mask) in enumerate(zip(bits, masks)):
        a = hs.sample_hash(p, BGG_KEY, f"dec_pk_{i}", 1, p.modulus_digits, FinRingDist())
        w = ((q // 2) * bit + mask) % q
        bottom = -g.mul_poly_scalar(Poly.const(p, w, dev))
        vec = state0 @ ts.preimage(p, td0, b0, a.concat_rows([bottom]))
        pks.append(a)
        outputs.append(masked_high_bit.MaskedHighBitEvaluatedOutput(
            [BggEncoding(vec, BggPublicKey(a, False), None)],
            [SimpleNamespace(plaintext=Poly.const(p, 0, dev))]))
    ts.take()
    rounding_ms = []
    rounding = masked_high_bit.decode_centered_masked_matrix

    def timed_rounding(*args):
        out, ms = timed(lambda: rounding(*args))
        rounding_ms.append(ms)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_decoder_") as tmp:
        arts = DirectoryDecoderArtifacts(tmp, "mhb")
        targets = {}

        def sampler(idx, target):
            targets[idx] = target
            return ts.preimage(p, td0, b0, target)

        dec = MaskedHighBitDecoder(p, 1, arts, sampler, lambda idx: f"out{idx}")
        pre_ms = [timed(lambda i=i, a=a: dec.preprocess_public_key_matrix(i, a))[1]
                  for i, a in enumerate(pks)]
        _, _, pre_calls, ok_pre = ts.take()
        stored = [arts.read_matrix(p, f"out{i}", dev) for i in range(len(pks))]
        ok_stored = all(m.data.is_cuda and b0 @ m == targets[i] and targets[i].shape == (2, 1)
                        for i, m in enumerate(stored))
        n_bytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
        masked_high_bit.decode_centered_masked_matrix = timed_rounding
        try:
            decoded, ms_decode = timed(lambda: dec.online_decode(
                masked_high_bit.MaskedHighBitOnlineInput(state0, outputs, [2] * len(bits))))
        finally:
            masked_high_bit.decode_centered_masked_matrix = rounding
    gone = not Path(tmp).exists()
    got = [d[0] for d in decoded]
    ok_rest = all(not any(d[1:]) and len(d) == p.n for d in decoded)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"masked decode n={p.n} L={p.crt_depth}, secret_size 1, {len(bits)} outputs: "
          f"{pre_calls} preimages, B0 P == target {ok_pre}, stored artifacts ({n_bytes} bytes) "
          f"read back on the card with B0 P == target {ok_stored}; bits {got} == {bits} "
          f"{got == bits}, other coefficients 0 {ok_rest} (masks below q/4); temporary "
          f"directory deleted {gone}; launches in the phase: fwd {counts['fwd']}, "
          f"inv {counts['inv']}", flush=True)
    timing("masked decode: preprocess_public_key_matrix", statistics.median(pre_ms), "ms",
           f" (median of {len(pre_ms)}: one 2 x 1 preimage and its artifact file)")
    timing("masked decode: online_decode", ms_decode / len(bits), "ms per output",
           f" ({ms_decode:.1f} ms for {len(bits)})")
    timing("masked decode: decode_centered_masked_matrix (host big-int rounding of n "
           "coefficients)", statistics.median(rounding_ms), "ms",
           f" (median of {len(rounding_ms)})")
    if not all((ok_pre, ok_stored, got == bits, ok_rest, gone)):
        raise SystemExit("chip_smoke: masked decoder check failed")
    require_launches("masked decode", counts)
    return {"launches": counts, "decode_ms": ms_decode, "outputs": len(bits)}


ST_KEY = bytes([5] * 32)
DIO_RING = (4096, 2, 28, 14)  # n, L, crt_bits, base_bits of the diamond io phase
DIO_SLOTS = 4


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


class HostRssPeak:
    """The host resident set over a `with` block: at its start and its peak,
    in GiB, sampled every 10 ms by a background thread from /proc/self/statm
    (a peak between two samples is missed). Where that file cannot be read,
    both stay None. `note` adds the process's peak resident set so far
    (`ru_maxrss`, which cannot be reset)."""

    def __enter__(self):
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        if self.start is not None:
            self._thread.start()
        return self

    @staticmethod
    def _rss() -> float | None:
        try:
            pages = int(Path("/proc/self/statm").read_text().split()[1])
        except (OSError, ValueError, IndexError):
            return None
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss() or 0.0)

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
            self.peak = max(self.peak, self._rss() or 0.0)
        return False

    def note(self) -> str:
        so_far = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        if self.start is None:
            return f"peak host RSS of the process so far {so_far:.2f} GiB (sampling not measured)"
        return (f"host RSS {self.start:.2f} GiB at the pass's start, peak {self.peak:.2f} GiB over "
                f"the pass and its barrier (sampled every 10 ms), peak of the process so far "
                f"{so_far:.2f} GiB")


def offline_host_note(rss: HostRssPeak, held: int, queued: int) -> str:
    """The host side of an offline pass that wrote through the native
    writer: its resident set, and how many queued files the writer still
    held (unwritten, or written and not yet released) when the pass
    returned, before the barrier."""
    return f"{rss.note()}; files held by the writer when the pass returned {held} of {queued}"


def drive_slot_transfer(p, dev, timing) -> dict:
    """Preimage-backed slot transfer over packed encodings (S = 3, d = 1):
    one slot transfer and one slot reduce of its output, the offline pass
    (pubkeys, `sample_aux_matrices` into a temporary directory), then a fresh
    online evaluator that only reads the artifacts. Returns the K1/K2 launch
    counts of the phase."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGPublicKeySampler
    from mxx_tpu_torch.bgg.poly_encoding import BGGPolyEncodingSampler
    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, TrapdoorSampler, UniformSampler
    from mxx_tpu_torch.slot_transfer.preimage import (
        BggPolyEncodingSTEvaluator,
        BggPublicKeySTEvaluator,
    )
    from mxx_tpu_torch.storage import init_storage_system, wait_for_all_writes

    S = 3
    secret = UniformSampler(seed=90, device=dev).sample_poly(p, TernaryDist())
    pubkeys = BGGPublicKeySampler(ST_KEY, 1, dev).sample(p, b"st", [True])
    sampler = BGGPolyEncodingSampler(p, [secret], S, None, seed=91)
    encs = sampler.sample(p, pubkeys, [[Poly.const(p, v, dev) for v in (2, 5, 7)]])
    t_row = PolyMatrix.from_poly_row(p, [secret])
    s_mats = [PolyMatrix.from_polys(p, [[m]]) for m in sampler.masks]
    circuit = PolyCircuit()
    w = circuit.input(1)
    moved = circuit.slot_transfer_gate(w[0], [(2, None), (0, 3), (1, None)])
    circuit.output([moved, circuit.slot_reduce_gate([moved], S)])

    calls = []  # (ms, columns, B, P, target): checked after the timed pass
    inner = TrapdoorSampler.preimage

    def counted(self, params, trapdoor, public_matrix, target):
        out, ms = timed(lambda: inner(self, params, trapdoor, public_matrix, target))
        calls.append((ms, target.ncol, public_matrix, out, target))
        return out

    tmp = Path(tempfile.mkdtemp(prefix="mxx_slot_transfer_"))
    try:
        torch.cuda.synchronize()
        reset_launches()
        init_storage_system(tmp)
        st_pk = BggPublicKeySTEvaluator(ST_KEY, S, 4.578, 0.0, tmp, seed=92, device=dev)
        TrapdoorSampler.preimage = counted
        try:
            def offline():
                pk = circuit.eval(p, pubkeys[0], pubkeys[1:], slot_transfer_evaluator=st_pk)
                st_pk.sample_aux_matrices(p, s_mats)
                wait_for_all_writes()
                return pk
            result_pk, ms_off = timed(offline)
        finally:
            TrapdoorSampler.preimage = inner
        nbytes = dir_bytes(tmp)
        b0 = st_pk.load_b0_matrix_checkpoint(p)

        def online():
            ev = BggPolyEncodingSTEvaluator(ST_KEY, tmp, st_pk.checkpoint_prefix(p), p,
                                            t_row @ b0)
            return circuit.eval(p, encs[0], encs[1:], slot_transfer_evaluator=ev)
        got, ms_on = timed(online)
        counts = launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    g = PolyMatrix.gadget_matrix(p, 1, dev)
    sg = sampler.secret_mat @ g

    def exact(enc):
        sa = sampler.secret_mat @ enc.pubkey.matrix
        return all(enc.vector(s) == sa.slice_rows(s, s + 1)
                   - sg.slice_rows(s, s + 1).mul_poly_scalar(enc.plaintext(s))
                   for s in range(enc.num_slots))

    ok_keys = all(a.pubkey == b for a, b in zip(got, result_pk))
    ok_pts = ([x.const_coeff() for x in got[0].plaintexts] == [7, 6, 5]
              and got[1].plaintext(0).coeffs()[:3] == [7, 6, 5])
    ok_inv = exact(got[0]) and exact(got[1])
    ok_pre = all(b @ x == t for _, _, b, x, t in calls)
    ms_pre = sum(c[0] for c in calls)
    cols = sum(c[1] for c in calls)
    print(f"slot transfer n={p.n} L={p.crt_depth} S={S} d=1: transfer [(2, -), (0, x3), (1, -)] "
          f"then reduce: online pubkeys == offline pass {ok_keys}, plaintexts [7, 6, 5] and "
          f"7 + 6X + 5X^2 {ok_pts}, c_s == sigma_s A - x_s sigma_s G on every slot {ok_inv} "
          f"(tolerance 0: exact); {len(calls)} preimage calls, {cols} columns, B P == target "
          f"{ok_pre}; artifacts {nbytes} B (directory deleted); launches in the phase: fwd "
          f"{counts['fwd']}, inv {counts['inv']}", flush=True)
    timing("slot transfer: offline (pubkey pass, aux preimages, writes)", ms_off, "ms",
           f" ({cols / ms_pre * 1e3:.1f} preimage-cols/s over {len(calls)} calls, "
           f"{ms_pre:.1f} ms; {nbytes} B of artifacts)")
    timing("slot transfer: online pass (reads and products)", ms_on, "ms")
    if not all((ok_keys, ok_pts, ok_inv, ok_pre)):
        raise SystemExit("chip_smoke: slot transfer check failed")
    require_launches("slot transfer", counts)
    return counts


GGH15_KEY = bytes([0x6B, 0x15, 0x0D, 0x2A] * 8)
COMMIT_KEY = bytes([0x3C] * 32)
COMMIT_RING = (8192, 3, 28, 14)  # n, L, crt_bits, base_bits of the commit lut phase
ERROR_SIGMA = 4.0
TRAPDOOR_SIGMA = 4.578
GGH15_SLOTS = 4


def ggh15_error_bound(p, circuit) -> int:
    """The simulated bound on the chain's output error (tests/test_noise_regime.py's
    model: NormPltGGH15Evaluator, inputs of plaintext norm p - 1 and error
    sigma * 6.5)."""
    from decimal import Decimal

    from mxx_tpu_torch.simulator import (
        NormPltGGH15Evaluator,
        SimulatorContext,
        simulate_max_error_norm,
    )

    ctx = SimulatorContext.for_params(p, 1)
    norm_eval = NormPltGGH15Evaluator(ctx, Decimal(ERROR_SIGMA), Decimal(ERROR_SIGMA))
    outs = simulate_max_error_norm(circuit, ctx, Decimal(P_MOD - 1), circuit.num_input,
                                   Decimal(ERROR_SIGMA) * Decimal("6.5"),
                                   plt_evaluator=norm_eval)
    return int(outs[0].matrix_norm.poly_norm.norm)


def drive_ggh15_chain(p, dev, timing) -> dict:
    """The LWE chain's workload with the GGH15 evaluators: offline pubkey
    pass, `sample_aux_matrices` and `wait_for_all_writes` into a temporary
    directory, then a fresh online evaluator that only reads the artifacts,
    and the packed pass over the same chain (GGH15_SLOTS slots, one secret
    per slot). Every preimage's target is captured at the preimage call and
    every stored L_x and gate stage read back and held to it. Returns the
    K1/K2 launch counts of the phase."""
    import random
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch import config
    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.bgg.poly_encoding import BGGPolyEncodingSampler
    from mxx_tpu_torch.lookup import PolyPltEvaluator, ggh15
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.native import writer
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.sampler import TernaryDist, TrapdoorSampler, UniformSampler
    from mxx_tpu_torch.storage import init_storage_system, wait_for_all_writes

    q = p.modulus
    k = p.modulus_digits
    m_b, m_g = k + 2, k
    circuit = mod_p_chain(p)
    rng = random.Random(1515)
    inputs = [rng.randrange(P_MOD) for _ in range(3)]
    slot_inputs = [[rng.randrange(P_MOD) for _ in range(GGH15_SLOTS)] for _ in range(3)]
    plaintexts = [Poly.const(p, v, dev) for v in inputs]
    secrets = [UniformSampler(seed=150, device=dev).sample_poly(p, TernaryDist())]
    pubkeys = BGGPublicKeySampler(GGH15_KEY, 1, device=dev).sample(p, b"ggh15", [True] * 3)
    es = BGGEncodingSampler(p, secrets, gauss_sigma=ERROR_SIGMA, seed=151)
    encodings = es.sample(p, pubkeys, plaintexts)
    packed = BGGPolyEncodingSampler(p, secrets, GGH15_SLOTS, ERROR_SIGMA, seed=152)
    slot_encs = packed.sample(p, pubkeys, [[Poly.const(p, v, dev) for v in vals]
                                           for vals in slot_inputs])

    entries = P_MOD * P_MOD
    n_luts = circuit.gate_counts()["PubLut"]
    poly_bytes = p.crt_depth * p.n * 4  # one poly's compact residues
    want_bytes = (entries * m_b * m_g + n_luts * (4 * m_b * m_g + m_b * m_b)) * poly_bytes
    cols = entries * m_g + n_luts * (4 * m_g + m_b)
    captured = {}  # id(preimage) -> (its public matrix, its target, the preimage)
    stored = {}  # stored prefix -> (public matrix, target, columns)
    calls = []  # requests per call of the preimage body (chunks of LUT_PREIMAGE_CHUNK_SIZE)
    chunk = config.lut_preimage_chunk_size()
    inner_pre = TrapdoorSampler.preimage_batched_chunked
    inner_store = ggh15.store_matrix_chunked

    def recording_pre(self, params, trapdoor, public_matrix, targets, *args, **kwargs):
        outs = inner_pre(self, params, trapdoor, public_matrix, targets, *args, **kwargs)
        calls.extend(min(chunk, len(targets) - i) for i in range(0, len(targets), chunk))
        for t, o in zip(targets, outs):
            captured[id(o)] = (public_matrix, t, o)
        return outs

    def recording_store(matrix, id_prefix):
        pub, target, _ = captured.pop(id(matrix))
        stored[id_prefix] = (pub, target, matrix.ncol)
        inner_store(matrix, id_prefix)

    tmp = Path(tempfile.mkdtemp(prefix="mxx_ggh15_chain_"))
    try:
        free = shutil.disk_usage(tmp).free
        print(f"ggh15 chain: artifacts {entries} L_x of [{m_b}, {m_g}] + {n_luts} gates x "
              f"(4 of [{m_b}, {m_g}] + P1 [{m_b}, {m_b}]) polys = {want_bytes} B to {tmp}; "
              f"free there {free} B", flush=True)
        if free < 2 * want_bytes:
            raise SystemExit(f"chip_smoke: {tmp} has {free} B free, under twice the "
                             f"{want_bytes} B of artifacts the GGH15 chain writes")
        init_storage_system(tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        pt, ms_oracle = timed(lambda: circuit.eval(p, Poly.one(p, dev), plaintexts,
                                                   plt_evaluator=PolyPltEvaluator())[0])
        pk_eval = ggh15.GGH15BGGPubKeyPltEvaluator(GGH15_KEY, 1, TRAPDOOR_SIGMA, ERROR_SIGMA,
                                                   tmp, seed=153, device=dev)
        out_pk, ms_pk = timed(lambda: circuit.eval(p, pubkeys[0], pubkeys[1:],
                                                   plt_evaluator=pk_eval)[0])
        cp = pk_eval.checkpoint_prefix(p)
        TrapdoorSampler.preimage_batched_chunked = recording_pre
        ggh15.store_matrix_chunked = recording_store
        try:
            with SpanLog() as spans, HostRssPeak() as rss:
                _, ms_aux = timed(lambda: pk_eval.sample_aux_matrices(p))
                held = writer.held_files()
                _, ms_wait = timed(wait_for_all_writes)
            host_note = offline_host_note(rss, held, len(spans.events("storage.write_part")))
        finally:
            TrapdoorSampler.preimage_batched_chunked = inner_pre
            ggh15.store_matrix_chunked = inner_store
        written = dir_bytes(tmp)

        # online: a fresh evaluator that reads the artifacts
        b0 = pk_eval.load_b0_matrix_checkpoint(p)
        c_b0 = es.secret_vec @ b0
        enc, ms_on = timed(lambda: circuit.eval(p, encodings[0], encodings[1:], plt_evaluator=(
            ggh15.GGH15BGGEncodingPltEvaluator(GGH15_KEY, tmp, cp, p, c_b0)))[0])
        slot_out, ms_packed = timed(lambda: circuit.eval(
            p, slot_encs[0], slot_encs[1:], plt_evaluator=ggh15.GGH15BGGPolyEncodingPltEvaluator(
                GGH15_KEY, tmp, cp, p, packed.secret_mat @ b0))[0])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()

        # every stored preimage read back and held to its captured target
        bad = [prefix for prefix, (pub, target, ncol) in stored.items()
               if not pub @ ggh15.read_matrix_chunked(p, tmp, prefix, ncol, dev) == target]
        n_lx = sum(1 for prefix in stored if "_lut_aux_" in prefix)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    expected = ((inputs[0] * inputs[1]) % P_MOD) * inputs[2] % P_MOD
    slot_expected = [((a * b) % P_MOD) * c % P_MOD for a, b, c in zip(*slot_inputs)]
    g = PolyMatrix.gadget_matrix(p, 1, dev)
    bound = ggh15_error_bound(p, circuit)

    def relation_error(secret_row, vector, pubkey, y) -> int:
        return max_centered(p, vector - secret_row @ pubkey.matrix
                            + (secret_row @ g).mul_poly_scalar(y))

    err = relation_error(es.secret_vec, enc.vector, enc.pubkey, enc.plaintext)
    slot_errs = [relation_error(packed.secret_mat.slice_rows(s, s + 1), slot_out.vector(s),
                                slot_out.pubkey, slot_out.plaintext(s))
                 for s in range(GGH15_SLOTS)]
    ok_oracle = pt.const_coeff() == expected and enc.plaintext.const_coeff() == expected
    ok_keys = enc.pubkey == out_pk and slot_out.pubkey == out_pk
    # the decode condition; the simulated bound is printed beside it, not
    # held: its G^{-1}(U_g) V_k term prices a zero-mean product, and the
    # chain's second lookup exceeds it (ROADMAP Open items)
    ok_err = 0 < err < q // 4 and bound < q // 4
    ok_slots = ([x.const_coeff() for x in slot_out.plaintexts] == slot_expected
                and all(0 < e < q // 4 for e in slot_errs))
    ok_pre = (not bad and not captured and n_lx == entries
              and len(stored) == entries + 5 * n_luts)

    def bits(v):
        return f"2^{math.log2(v):.2f}" if v else "0"

    print(f"ggh15 chain n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits {p.base_bits} "
          f"d=1 p={P_MOD}, {entries}-entry LUT, {circuit.gate_counts()}, error sigma "
          f"{ERROR_SIGMA}: plaintext == oracle {ok_oracle}, encoding pubkeys == pubkey pass "
          f"{ok_keys}, error {err} = {bits(err)} in (0, q/4 = {bits(q // 4)}) and the simulated "
          f"bound {bits(bound)} under q/4: {ok_err} (error / bound = 2^"
          f"{math.log2(err / bound) if err else float('-inf'):.2f}); B1 L_x == target for {n_lx} stored L_x "
          f"and B0 P == target for {len(stored) - n_lx} gate stages: {ok_pre} ({len(bad)} "
          f"bad; tolerance 0: exact); packed {GGH15_SLOTS} slots {slot_inputs}: plaintexts "
          f"{[x.const_coeff() for x in slot_out.plaintexts]} == oracle {slot_expected} and "
          f"slot errors {[bits(e) for e in slot_errs]} in (0, q/4): {ok_slots}; launches "
          f"in the phase: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    pre_ms = spans.total_ms("ggh15.preimages")
    span_cols = sum(r.fields["cols"] for r in spans.named("ggh15.preimages"))
    writes = spans.events("storage.write_part")
    timing("ggh15 chain: plaintext oracle", ms_oracle, "ms")
    timing("ggh15 chain: pubkey pass", ms_pk, "ms")
    timing("ggh15 chain: sample_aux_matrices", ms_aux, "ms",
           f" (trapdoors {spans.total_ms('ggh15.trapdoors'):.1f} ms, LUT targets "
           f"{spans.total_ms('ggh15.lut_targets'):.1f} ms, preimages {pre_ms:.1f} ms, stores "
           f"(device-to-host copy + serialize + enqueue) {spans.total_ms('ggh15.store'):.1f} "
           f"ms; wait_for_all_writes {ms_wait:.1f} ms)")
    timing("ggh15 chain: preimages", span_cols / pre_ms * 1e3, "preimage-cols/s",
           f" ({span_cols} cols in {len(calls)} calls of {calls} requests, {pre_ms:.1f} ms; "
           f"reckoned "
           f"{cols} cols)")
    timing("ggh15 chain: artifacts written", written / 1e9, "GB",
           f" ({written} B, reckoned {want_bytes} B of payloads; "
           f"{written / (ms_aux + ms_wait) / 1e6:.3f} GB/s over sample_aux_matrices + "
           f"wait_for_all_writes; {len(writes)} parts queued to the C++ writer without a copy; "
           f"{host_note})")
    timing("ggh15 chain: online encoding pass", ms_on, "ms")
    timing(f"ggh15 chain: packed pass ({GGH15_SLOTS} slots)", ms_packed, "ms")
    timing("ggh15 chain: peak device memory", peak / 2**30, "GiB")
    if not all((ok_oracle, ok_keys, ok_err, ok_slots, ok_pre)):
        raise SystemExit(f"chip_smoke: GGH15 chain check failed (bad preimages {bad[:5]})")
    require_launches("ggh15 chain", counts)
    return counts


def commit_sizes(args) -> tuple[int, int, int]:
    """(polys, int64 bytes, preimage columns) of WEE25's T_top at d=1,
    tree_base 2 on the ring `args` (n, L, crt_bits, base_bits)."""
    n, L, crt_bits, base_bits = args
    k = L * -(-crt_bits // base_bits)
    m_b = k + 2
    blocks = 2 * m_b * k  # l * m_g
    j2m = 2 * m_b * k
    polys = blocks * m_b * j2m
    return polys, polys * L * n * 8, blocks * j2m


def drive_commit_lut(p, dev, timing) -> dict:
    """WEE25 and the commitment-backed LUT at a ring cut to fit T_top
    (COMMIT_RING): the public params, a commit/open/verify over a tree of 8
    uniform blocks (and a tampered message), then the mod-p chain with
    zero-error encodings: the offline pass and `commit_all_lut_matrices`
    into a temporary directory, and a fresh online evaluator that reads the
    commitment preimage. Also one `rlwe_encrypt` at the realistic ring.
    Returns the K1/K2 launch counts of the phase."""
    import random
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGEncodingSampler, BGGPublicKeySampler
    from mxx_tpu_torch.commit import MsgMatrixStream, Wee25Commit
    from mxx_tpu_torch.lookup import PolyPltEvaluator
    from mxx_tpu_torch.lookup.commit_eval import (
        PREIMAGE_OF_COMMIT_ID,
        CommitBGGEncodingPltEvaluator,
        CommitBGGPubKeyPltEvaluator,
        derive_a_out_matrix,
    )
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.ring.poly import Poly
    from mxx_tpu_torch.rlwe_enc import rlwe_encrypt
    from mxx_tpu_torch.sampler import (
        BitDist,
        FinRingDist,
        TernaryDist,
        TrapdoorSampler,
        UniformSampler,
    )
    from mxx_tpu_torch.storage import (
        init_storage_system,
        read_matrix_from_multi_batch,
        wait_for_all_writes,
    )

    pc = RingParams.new(*COMMIT_RING)
    walls = {L: commit_sizes((pc.n, L, pc.crt_bits, pc.base_bits)) for L in (2, 3, 4, p.crt_depth)}
    print(f"commit lut: T_top at n={pc.n} crt_bits {pc.crt_bits} base_bits {pc.base_bits} d=1 "
          f"tree_base 2 by depth (polys, int64 bytes on the card, preimage columns): "
          + "; ".join(f"L={L}: {v[0]}, {v[1]} B, {v[2]}" for L, v in walls.items())
          + f"; cut to L={pc.crt_depth} (the realistic L={p.crt_depth} needs "
          f"{walls[p.crt_depth][1]} B)", flush=True)
    k = pc.modulus_digits
    scheme = Wee25Commit(1, 2, k + 2, k, TRAPDOOR_SIGMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = {}
    pp, ms["public params"] = timed(lambda: scheme.sample_public_params(
        pc, COMMIT_KEY, seed=160, device=dev))
    pp_cols = scheme.l * scheme.m_g * scheme.l * k

    # a WEE25 tree of 8 uniform blocks
    us = UniformSampler(seed=161, device=dev)
    blocks = [us.sample_uniform(pc, 1, scheme.m_b, FinRingDist()) for _ in range(8)]
    stream = MsgMatrixStream.from_blocks(blocks)
    (commitment, cache), ms["commit, 8 blocks"] = timed(lambda: scheme.commit(pc, stream, pp))
    openings = []
    for col in range(len(blocks)):
        z, ms_open = timed(lambda c=col: scheme.open(pc, stream, range(c, c + 1), pp, cache))
        openings.append(z)
        ms.setdefault("openings", []).append(ms_open)
    msg = blocks[0].concat_columns(blocks[1:])
    opening = openings[0].concat_columns(openings[1:])
    ok_verify, ms["verify"] = timed(lambda: scheme.verify(pc, msg, commitment, opening, None, pp))
    bad_msg = msg + PolyMatrix.identity(pc, 1, device=dev).concat_columns(
        [PolyMatrix.zero(pc, 1, msg.ncol - 1, device=dev)])
    ok_tamper = not scheme.verify(pc, bad_msg, commitment, opening, None, pp)

    # the mod-p chain through the commitment LUT
    circuit = mod_p_chain(pc)
    rng = random.Random(1616)
    inputs = [rng.randrange(P_MOD) for _ in range(3)]
    plaintexts = [Poly.const(pc, v, dev) for v in inputs]
    secrets = [UniformSampler(seed=162, device=dev).sample_poly(pc, TernaryDist())]
    pubkeys = BGGPublicKeySampler(COMMIT_KEY, 1, device=dev).sample(pc, b"commit", [True] * 3)
    es = BGGEncodingSampler(pc, secrets)  # zero error: the scheme decodes only so
    encodings = es.sample(pc, pubkeys, plaintexts)
    ts = TrapdoorSampler(pc, TRAPDOOR_SIGMA, seed=163, device=dev)
    b0_td, b0 = ts.trapdoor(pc, 1)
    s_vec = es.secret_vec
    tmp = Path(tempfile.mkdtemp(prefix="mxx_commit_lut_"))
    try:
        init_storage_system(tmp)
        off = CommitBGGPubKeyPltEvaluator(pc, scheme, pp, COMMIT_KEY)
        out_pk, ms["pubkey pass"] = timed(lambda: circuit.eval(pc, pubkeys[0], pubkeys[1:],
                                                               plt_evaluator=off)[0])

        def commit_all():
            off.commit_all_lut_matrices(ts, b0_td, b0)
            wait_for_all_writes()
        _, ms["commit_all_lut_matrices"] = timed(commit_all)
        on, ms["online evaluator set-up"] = timed(lambda: CommitBGGEncodingPltEvaluator(
            pc, scheme, pp, COMMIT_KEY, circuit, pubkeys[0], pubkeys[1:], s_vec @ b0,
            s_vec @ pp.b, tmp))
        enc, ms["online encoding pass"] = timed(lambda: circuit.eval(
            pc, encodings[0], encodings[1:], plt_evaluator=on)[0])
        preimage = read_matrix_from_multi_batch(pc, tmp, PREIMAGE_OF_COMMIT_ID, 0, dev)
        table_commit, _ = scheme.commit(pc, on.stream, pp)
        ok_pre = b0 @ preimage == table_commit + on.b_1
        nbytes = dir_bytes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del pp, cache, openings, on

    pt = circuit.eval(pc, Poly.one(pc, dev), plaintexts, plt_evaluator=PolyPltEvaluator())[0]
    expected = ((inputs[0] * inputs[1]) % P_MOD) * inputs[2] % P_MOD
    out_gate = circuit.output_ids[0]
    ok_key = (enc.pubkey == out_pk
              and out_pk.matrix == derive_a_out_matrix(pc, 1, COMMIT_KEY, out_gate, dev))
    ok_oracle = pt.const_coeff() == expected and enc.plaintext.const_coeff() == expected
    g = PolyMatrix.gadget_matrix(pc, 1, dev)
    ok_exact = enc.vector == s_vec @ (enc.pubkey.matrix - g.mul_poly_scalar(enc.plaintext))

    # one RLWE encryption of random bits at the realistic ring, decrypted
    ur = UniformSampler(seed=164, device=dev)
    m = ur.sample_poly(p, BitDist())
    a = ur.sample_uniform(p, 1, 1, FinRingDist())
    t = ur.sample_uniform(p, 1, 1, TernaryDist())
    m_mat = PolyMatrix.from_poly_row(p, [m])
    b, ms["rlwe_encrypt"] = timed(lambda: rlwe_encrypt(p, ur, t, a, m_mat, ERROR_SIGMA))
    q = p.modulus
    quarter = ((q + 1) // 2) >> 1
    recovered = (b - a @ t).entry(0, 0).coeffs()
    ok_rlwe = [quarter <= c < 3 * quarter for c in recovered] == [c == 1 for c in m.coeffs()]
    torch.cuda.synchronize()

    print(f"commit lut n={pc.n} L={pc.crt_depth} crt_bits {pc.crt_bits} base_bits "
          f"{pc.base_bits} d=1 tree_base 2 (m_b {scheme.m_b}, l {scheme.l}, "
          f"{scheme.l * scheme.m_g} T_top blocks): WEE25 over 8 blocks verifies {ok_verify}, "
          f"tampered message rejected {ok_tamper}; chain {circuit.gate_counts()} over the "
          f"{P_MOD * P_MOD}-entry table, zero-error encodings: output pubkey == pubkey pass == "
          f"derive_a_out_matrix {ok_key}, plaintext == oracle {ok_oracle}, c == s (A_out - G y) "
          f"{ok_exact}, B0 preimage == commit + B_1 {ok_pre} (tolerance 0: exact); artifacts "
          f"{nbytes} B (directory deleted); rlwe_encrypt at n={p.n} L={p.crt_depth} decrypts "
          f"every bit {ok_rlwe}; launches in the phase: fwd {counts['fwd']}, inv "
          f"{counts['inv']}", flush=True)
    timing(f"commit lut: public params (L={pc.crt_depth})", pp_cols / ms["public params"] * 1e3,
           "preimage-cols/s", f" ({ms['public params']:.1f} ms, {pp_cols} cols; T_top "
           f"{walls[pc.crt_depth][1]} B)")
    for name in ("commit, 8 blocks", "verify", "pubkey pass", "commit_all_lut_matrices",
                 "online evaluator set-up", "online encoding pass"):
        timing(f"commit lut: {name}", ms[name], "ms")
    timing("commit lut: openings of the 8-block tree", statistics.median(ms["openings"]), "ms",
           " per opening (median; each " + ", ".join(f"{v:.1f}" for v in ms["openings"])
           + " ms)")
    timing(f"commit lut: rlwe_encrypt n={p.n} L={p.crt_depth}", ms["rlwe_encrypt"], "ms")
    timing(f"commit lut: peak device memory (L={pc.crt_depth})", peak / 2**30, "GiB")
    if not all((ok_verify, ok_tamper, ok_key, ok_oracle, ok_exact, ok_pre, ok_rlwe)):
        raise SystemExit("chip_smoke: commit LUT check failed")
    require_launches("commit lut", counts)
    return counts


def ms_plain(p, data, new_modulus):
    """The modulus switch of `PolyMatrix.modulus_switch` restated limb by
    limb in numpy on the host (the same integer parts and float64 fractions,
    in the same order)."""
    import numpy as np

    ints, fracs = p.ms_tables(new_modulus)
    P = np.int64(new_modulus)
    hi = np.zeros(data.shape[1:], dtype=np.int64)
    fr = np.zeros(data.shape[1:], dtype=np.float64)
    for t in range(p.crt_depth):
        r = data[t]
        hi = (hi + (r * ints[t]) % P) % P
        fr = fr + r.astype(np.float64) * fracs[t]
    fl = np.floor(fr)
    v = (hi + (fl.astype(np.int64) + (fr - fl >= 0.5)) % P) % P
    return np.stack([v % np.int64(q) for q in p.moduli])


def drive_modulus_switch(p, dev, timing) -> None:
    """`PolyMatrix.modulus_switch(q_i)` of a uniform [1, 16] matrix for each
    limb: every coefficient of 4 sampled entries against the exact host
    rounding (c P + q // 2) // q mod P, and the whole result against the
    plain limb-by-limb version."""
    import numpy as np

    from mxx_tpu_torch.ring.poly import COEFF
    from mxx_tpu_torch.sampler import FinRingDist, UniformSampler

    m = UniformSampler(seed=171, device=dev).sample_uniform(p, 1, 16, FinRingDist())
    m = type(m)(m.data, COEFF, p)
    data = m.data.cpu().numpy()
    q = p.modulus
    cols = [0, 5, 10, 15]
    coeffs = [[p.reconstruct_coeff(data[:, 0, j, t]) for t in range(p.n)] for j in cols]
    mism_exact = mism_plain = 0
    checked = 0
    for P in p.moduli:
        got = m.modulus_switch(P).data.cpu().numpy()
        mism_plain += int((got != ms_plain(p, data, P)).sum())
        for jj, j in enumerate(cols):
            want = np.array([(c * P + q // 2) // q % P for c in coeffs[jj]], dtype=np.int64)
            mism_exact += int((got[:, 0, j, :] != (want[None, :] % np.array(
                p.moduli, dtype=np.int64)[:, None])).sum())
            checked += p.n
    ms = cuda_ms(lambda: m.modulus_switch(p.moduli[0]), 10)
    print(f"modulus switch n={p.n} L={p.crt_depth} [1, 16] to each of the {p.crt_depth} limbs: "
          f"{checked} coefficients of 4 entries against the exact host rounding, "
          f"{mism_exact} residue mismatches; whole results against the plain limb-by-limb "
          f"version, {mism_plain} mismatches (tolerance 0)", flush=True)
    timing(f"modulus switch [1, 16] n={p.n} L={p.crt_depth} to q_0", ms, "ms per call")
    if mism_exact or mism_plain:
        raise SystemExit("chip_smoke: modulus switch check failed")


def xor_and_builder(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1]), circuit.and_gate(bits[0], bits[1])]


def dio_prf_config():
    from mxx_tpu_torch.io_protocols.prf_mask import PrfConfig

    # tests/test_diamond_io.py `_ci_prf_config`
    return PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                     max_unreduced_muls=1, noise_refresh_v_bits=1,
                     debug_encrypt_random_prg_wires=True, debug_reuse_single_material=True,
                     refresh_wire_limit=1)


def drive_diamond_io(p, dev, timing, slots: int = DIO_SLOTS) -> dict:
    """Diamond iO in packed payload mode with debug replay (the JAX package's
    `test_diamond_io_packed_payload_e2e` shape): obfuscate XOR/AND of two
    bits into a temporary directory, evaluate [0, 1] and [1, 1], check the
    decodes and c_one == sigma (A_one - G). Returns the K1/K2 launch counts
    of the phase ("launches") and what the estimators phase compares: the
    obfuscate and eval ms, the transition and decoder preimages made, the
    artifact bytes and the `DiamondIO`."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGPublicKeySampler
    from mxx_tpu_torch.io_protocols import DiamondIO
    from mxx_tpu_torch.io_protocols.prf_mask import PrfDebugArtifacts
    from mxx_tpu_torch.lookup.debug import (
        DebugBGGEncodingPltEvaluator,
        DebugBGGPubKeyPltEvaluator,
    )
    from mxx_tpu_torch.matrix import PolyMatrix

    dio = DiamondIO(
        p, input_count=2, batch_bits=1, seed=91, prf_config=dio_prf_config(),
        payload_slots=slots, device=dev,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(obf.hash_key,
                                         s.injector.debug_final_secret_matrix(d, digits)),
    )
    parts: dict = {}
    instrument(dio._trap, "preimage", parts, "trapdoor preimages (rebase, refresh, final, "
               "decoder)")
    instrument(dio, "_sample_final_output_preimage", parts, "of them final output preimages")
    instrument(dio.injector._trap, "preimage_batched_chunked", parts,
               "injector transition preimages", lambda a, out: len(a[3]))
    instrument(dio, "_write", parts, "artifact writes",
               lambda a, out: str(a[1]).startswith("decoder_preimage_"))
    tmp = Path(tempfile.mkdtemp(prefix="mxx_diamond_io_"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SpanLog() as obf_log:
            obf, ms_obf = timed(lambda: dio.obfuscate(tmp, xor_and_builder))
        nbytes = dir_bytes(tmp)
        peak_obf = torch.cuda.max_memory_allocated()
        results = []
        for bits in ([0, 1], [1, 1]):
            torch.cuda.reset_peak_memory_stats()
            with SpanLog() as log:
                out, ms = timed(lambda b=bits: dio.eval(tmp, obf, xor_and_builder, b))
            results.append((bits, out, ms, list(dio.last_decode_margins), log,
                            torch.cuda.max_memory_allocated()))
        counts = launch_counts()
        digits = [1, 1]
        states = dio.injector.online_eval(tmp, obf.preprocess_out, digits)
        sigma = dio.injector.debug_final_secret_matrix(tmp, digits)
        one_pk = BGGPublicKeySampler(obf.hash_key, 1, dev).sample(p, b"diamond_bgg", [True] * 2)[0]
        c_one = states[0] @ dio._read(tmp, "one_preimage")
        ok_one = c_one == sigma @ (one_pk.matrix - PolyMatrix.gadget_matrix(p, 1, dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    prf = dio._prf_pipeline()
    wrapped = dio._build_wrapped_circuit(prf, xor_and_builder, obf.unit_ct_consts,
                                         obf.num_outputs, obf.prf_debug or PrfDebugArtifacts())
    refresh = [c for k, c in prf.refresher._decrypt_circuits.items() if k[0] == "packed"]

    def gates(c):
        return sum(v for g, v in c.gate_counts().items() if g != "Input")

    # the cut against the realistic ring, from the port's own counts
    from mxx_tpu_torch.io_protocols.prf_mask import PrfMaskPipeline
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.sampler import TrapdoorSampler

    def enc_bytes(r):  # vector and public key [L, 1, m, n], plaintext [L, n], int64
        return (2 * r.modulus_digits + 1) * r.crt_depth * r.n * 8

    full = RingParams.new(8192, 8, 28, 14)
    wpc_full = PrfMaskPipeline(full, dio_prf_config(), bytes(32),
                               TrapdoorSampler(full, 4.578, seed=0, device=dev), 2, 1,
                               num_slots=slots).wires_per_ct
    mask_inputs = wrapped.num_input - 3
    read = sum(1 for u in wrapped.use_counts()[4:wrapped.num_input + 1] if u)
    full_inputs = obf.num_outputs * slots * wpc_full
    peak_eval = max(r[5] for r in results)
    print(f"diamond io: ring cut to n={p.n}, L={p.crt_depth} from n=8192, L=8: the wrapped "
          f"circuit's mask-ciphertext inputs are {full_inputs} vec wires x {slots} slots of "
          f"{enc_bytes(full)} B per encoding = {full_inputs * slots * enc_bytes(full) / 1e12:.2f} "
          f"TB at n=8192, L=8 ({wpc_full} wires per ciphertext); at L={p.crt_depth} they are "
          f"{mask_inputs} x {slots} (the decrypt reads {read} of them, the only ones lifted) = "
          f"{read * slots * enc_bytes(RingParams.new(8192, p.crt_depth, 28, 14)) / 1e9:.1f} GB "
          f"at n=8192, and the measured eval peak of {peak_eval / 2**30:.2f} GiB at n={p.n} "
          f"doubles with n, past the card's 80 GB; L={p.crt_depth} is the smallest depth at "
          f"which the refresh rounds (at L=1 q_hat = 1 and the switch is the identity)",
          flush=True)
    print("diamond io: packed debug replay is the mode whose size does not grow with n: "
          "scalar payload mode decrypts n x prf_mask_output_coeff_bits mask ciphertexts per "
          "output and refreshes with n error ciphertexts per digit, and real mode evaluates "
          "the Goldreich PRG over the ciphertext wires themselves", flush=True)
    ok_dec = all(out == [b[0] ^ b[1], b[0] & b[1]] for b, out, *_ in results)
    for bits, out, ms, margins, log, peak in results:
        print(f"diamond io eval {bits}: decoded {out}, want {[bits[0] ^ bits[1], bits[0] & bits[1]]}"
              f"; decode margins (distance to the nearest q/2 codeword, of q = {p.modulus}): "
              f"{[m[1] for m in margins]}", flush=True)
    print(f"diamond io n={p.n} L={p.crt_depth} packed payload_slots {slots}, debug replay: "
          f"decodes {ok_dec}, c_one == sigma (A_one - G) {ok_one} (tolerance 0: exact); "
          f"wrapped circuit {gates(wrapped)} gates ({wrapped.gate_counts().get('PubLut', 0)} "
          f"PubLut, {wrapped.num_input} inputs), refresh decrypt circuit "
          f"{[gates(c) for c in refresh]} gates; artifacts {nbytes} B (directory deleted); "
          f"launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    timing("diamond io: obfuscate", ms_obf / 1e3, "s", "".join(
        f"; {name} {obf_log.total_ms(span) / 1e3:.3f} s" for name, span in (
            ("injector preprocess", "diamond_injector.preprocess"),
            ("PRF public-key path", "prf_pipeline.pk_round_packed"),
            ("of it packed refresh decrypts", "noise_refresh.packed_material_decrypt"),
            ("wrapped pubkey pass", "diamond_io.pk_circuit_eval")))
        + "".join(f"; {k} {sum(x[0] for x in v) / 1e3:.3f} s ({len(v)} calls)"
                  for k, v in parts.items()))
    for bits, out, ms, margins, log, peak in results:
        timing(f"diamond io: eval {bits}", ms / 1e3, "s", "".join(
            f"; {name} {log.total_ms(span) / 1e3:.3f} s" for name, span in (
                ("injector online", "diamond_injector.online_eval"),
                ("PRF encoding path", "prf_pipeline.enc_round_packed"),
                ("of it packed refresh decrypts", "noise_refresh.packed_material_decrypt"),
                ("wrapped encoding pass", "diamond_io.enc_circuit_eval")))
            + f"; peak device memory {peak / 2**30:.2f} GiB")
    timing("diamond io: obfuscate peak device memory", peak_obf / 2**30, "GiB",
           f"; artifacts {nbytes} B")
    if not (ok_dec and ok_one):
        raise SystemExit("chip_smoke: Diamond iO check failed")
    require_launches("diamond io", counts)
    return {"launches": counts, "obfuscate_ms": ms_obf, "eval_ms": [r[2] for r in results],
            "transition_preimages": sum(x[1] for x in parts["injector transition preimages"]),
            "decoder_preimages": sum(x[1] for x in parts["artifact writes"]),
            "artifact_bytes": nbytes, "dio": dio}


AKY24_IO_KW = dict(  # tests/test_aky24_io.py `IO_KW`
    bgg_tag=b"aky24", input_size=2, output_size=1, seed_bits=32, prf_batch_bits=1,
    prf_mask_output_coeff_bits=4, noise_refresh_v_bits=8, noise_refresh_cbd_n=4)


def aky24_lut_circuit(p):
    """tests/test_aky24_io.py `make_circuit`: Mul -> PubLut (x mod 3)."""
    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.lookup import PublicLut

    c = PolyCircuit()
    w = c.input(2)
    lid = c.register_public_lut(PublicLut.from_dict(p, {x: (x, x % 3) for x in range(9)}))
    c.output([c.public_lookup_gate(c.mul_gate(w[0], w[1]), lid)])
    return c


def drive_estimators(p, pd, dev, timing, we, fe, decode, dio) -> dict:
    """The bench estimators on the card: per-op costs measured at the ring
    `p` of phases 8-12 and at the ring `pd` of Diamond iO; the estimates they
    give for the WE, FE, masked-decode and Diamond iO phases beside the times
    those phases measured in this run; the estimated preimage counts beside
    the preimages the runs made; the AKY24 iO estimate and its CRT-depth
    search at the ring dimension of `p`. Returns the K1/K2 launch counts of
    the phase."""
    import torch

    from mxx_tpu_torch.bench_estimator import (
        measure_bgg_encoding_costs,
        measure_bgg_poly_encoding_costs,
        measure_naive_vec_costs,
        measure_poly_costs,
    )
    from mxx_tpu_torch.decoder.bench import estimate_decoder_scaling, measure_masked_decode_cost
    from mxx_tpu_torch.func_enc.bench import estimate_aky24_dec, estimate_aky24_keygen
    from mxx_tpu_torch.io_protocols import Aky24IO, aky24_io_find_crt_depth, simulate_aky24_io
    from mxx_tpu_torch.io_protocols.aky24_io import estimate_aky24_io
    from mxx_tpu_torch.io_protocols.bench_estimator import (
        estimate_diamond_io,
        measure_preimage_cost,
    )
    from mxx_tpu_torch.we.bench_estimator import estimate_diamond_we

    bad_costs, counts_equal = [], []

    def cost(label, seconds):
        if not (math.isfinite(seconds) and seconds > 0):
            bad_costs.append(label)
        timing(f"estimators: cost {label}", seconds * 1e3, "ms")
        return seconds

    def model(label, m):
        for kind, seconds in m.costs.items():
            cost(f"{label} {kind}", seconds)
        return m

    def compare(label, estimate_s, measured_ms):
        timing(f"estimators: {label}: estimate", estimate_s * 1e3, "ms",
               f"; measured in this run {measured_ms:.1f} ms; estimate / measured "
               f"{estimate_s * 1e3 / measured_ms:.4f}")

    def count(label, estimated, made):
        counts_equal.append(estimated == made)
        print(f"estimators: {label} {estimated}; made in this run {made}; equal "
              f"{estimated == made}", flush=True)

    torch.cuda.synchronize()
    reset_launches()
    k = p.modulus_digits
    tag = f"n={p.n} L={p.crt_depth}"
    model(f"{tag} poly", measure_poly_costs(p, device=dev))
    bgg = model(f"{tag} bgg encoding d=1", measure_bgg_encoding_costs(p, 1, device=dev))
    bgg2 = model(f"{tag} bgg encoding d=2", measure_bgg_encoding_costs(p, 2, device=dev))
    model(f"{tag} bgg poly encoding 4 slots", measure_bgg_poly_encoding_costs(p, 4, device=dev))
    model(f"{tag} naive vec 4 slots", measure_naive_vec_costs(p, 4, device=dev))
    pre1 = cost(f"{tag} preimage d=1 ({k + 2} cols)", measure_preimage_cost(p, d=1, device=dev))
    pre2 = cost(f"{tag} preimage d=2 ({2 * (k + 2)} cols)",
                measure_preimage_cost(p, d=2, device=dev))
    pre_fe = cost(f"{tag} preimage d=2 (1 col, the FE keygen's)",
                  measure_preimage_cost(p, d=2, cols=1, device=dev))
    dec_cost = cost(f"{tag} masked decode secret_size 1",
                    measure_masked_decode_cost(p, 1, device=dev))

    for i, run in enumerate(we["runs"]):
        est = estimate_diamond_we(run["injector"], run["circuit"], 1, 1, pre2, bgg)
        compare(f"diamond we encryption {i}: enc", est.enc_latency_secs, run["enc_ms"])
        compare(f"diamond we encryption {i}: dec", est.dec_latency_secs, run["dec_ms"])
        count(f"diamond we encryption {i}: injector_preimage_count", est.injector_preimage_count,
              run["transition_preimages"])
    kg = estimate_aky24_keygen(p, fe["circuit"], 1, pre_fe, bgg2, secret_size=2)
    fd = estimate_aky24_dec(p, fe["circuit"], 1, bgg2)
    compare("aky24 fe keygen", kg.total_secs, fe["ms"]["keygen"])
    compare("aky24 fe dec (median of four)", fd.total_secs, fe["ms"]["dec"])
    ds = estimate_decoder_scaling(p, [decode["outputs"]], per_output_cost=dec_cost)
    compare(f"masked decode, online_decode of {decode['outputs']} outputs", ds.latency_secs[0],
            decode["decode_ms"])
    aio = estimate_aky24_io(Aky24IO(params=p, **AKY24_IO_KW), aky24_lut_circuit(p), 1, pre1, bgg)
    timing("estimators: aky24 io (tests/test_aky24_io.py circuit and IO_KW): obfuscate estimate",
           aio.obfuscate_latency_secs, "s", f"; eval estimate {aio.eval_latency_secs * 1e3:.3f} ms;"
           f" {aio.prf_preimage_count} PRF preimages (no run to compare)")

    kd = pd.modulus_digits
    dtag = f"n={pd.n} L={pd.crt_depth}"
    pre_dio = cost(f"{dtag} preimage d=2 ({2 * (kd + 2)} cols)",
                   measure_preimage_cost(pd, d=2, device=dev))
    naive_dio = model(f"{dtag} naive vec {DIO_SLOTS} slots",
                      measure_naive_vec_costs(pd, DIO_SLOTS, device=dev))
    est = estimate_diamond_io(dio["dio"], xor_and_builder, 1, pre_dio, naive_dio)
    compare("diamond io obfuscate", est.obfuscate_latency_secs, dio["obfuscate_ms"])
    for bits, ms in zip(([0, 1], [1, 1]), dio["eval_ms"]):
        compare(f"diamond io eval {bits}", est.eval_latency_secs, ms)
    count("diamond io injector_preimage_count", est.injector_preimage_count,
          dio["transition_preimages"])
    count("diamond io decoder_preimage_count", est.decoder_preimage_count,
          dio["decoder_preimages"])
    print(f"estimators: diamond io artifact_bytes {est.artifact_bytes}; written in this run "
          f"{dio['artifact_bytes']}; estimate / written "
          f"{est.artifact_bytes / dio['artifact_bytes']:.4f}", flush=True)
    torch.cuda.synchronize()
    launches = launch_counts()

    found = aky24_io_find_crt_depth(aky24_lut_circuit, p.n, p.crt_bits, p.base_bits, 8,
                                    AKY24_IO_KW)
    ok_depth = False
    if found is not None:
        depth, fp = found
        sim = simulate_aky24_io(Aky24IO(params=fp, **AKY24_IO_KW), aky24_lut_circuit(fp))
        ok_depth = sim.ok
        print(f"estimators: aky24_io_find_crt_depth n={p.n} crt_bits {p.crt_bits} base_bits "
              f"{p.base_bits}, up to depth 8: depth "
              f"{depth} (q of {fp.modulus.bit_length()} bits), circuit error "
              f"{sim.circuit_error_bits} bits, decode margin {sim.decode_margin_bits} bits, ok "
              f"{sim.ok}", flush=True)
    print(f"estimators: launches in the phase: fwd {launches['fwd']}, inv {launches['inv']}",
          flush=True)
    if bad_costs:
        raise SystemExit(f"chip_smoke: costs not finite and positive: {bad_costs}")
    if not all(counts_equal):
        raise SystemExit("chip_smoke: an estimated preimage count differs from the run's")
    if not ok_depth:
        raise SystemExit("chip_smoke: the AKY24 iO depth search found no depth that checks ok")
    require_launches("estimators", launches)
    return launches


CORE_KEY = bytes([0x5A] * 32)
CHUNK_KNOB = "MXX_MUL_DECOMPOSE_COLUMN_CHUNK_WIDTH"


def chunked_mul_decompose(a, b, width: int):
    """(a.mul_decompose(b), ms, peak bytes above those allocated before the
    call) under the column-chunk width `width` (0: G^-1(b) whole), the knob
    restored after."""
    import os

    import torch

    saved = os.environ.get(CHUNK_KNOB)
    os.environ[CHUNK_KNOB] = str(width)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, ms = timed(lambda: a.mul_decompose(b))
        return out, ms, torch.cuda.max_memory_allocated() - before
    finally:
        if saved is None:
            os.environ.pop(CHUNK_KNOB)
        else:
            os.environ[CHUNK_KNOB] = saved


def drive_core_ops(p, dev, timing) -> dict:
    """The matrix, poly, sampler and serde operations of slice 10 at the
    realistic ring, each checked exactly. Returns the K1/K2 launch counts."""
    import random
    import tempfile

    import torch

    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.matrix.poly_matrix import host_u32
    from mxx_tpu_torch.native import codec
    from mxx_tpu_torch.ring.poly import COEFF, Poly
    from mxx_tpu_torch.sampler import FinRingDist, HashSampler, UniformSampler

    us = UniformSampler(seed=191, device=dev)
    uni = FinRingDist()
    k, dpt = p.modulus_digits, p.digits_per_tower
    a = us.sample_uniform(p, 2, 2 * k, uni).to_eval()
    b = us.sample_uniform(p, 2, 512, uni).to_eval()
    torch.cuda.synchronize()
    reset_launches()

    # mul_decompose, whole and in column chunks of 64
    whole, ms_whole, peak_whole = chunked_mul_decompose(a, b, 0)
    chunks, ms_chunks, peak_chunks = chunked_mul_decompose(a, b, 64)
    ok_chunks = whole == chunks
    del whole, chunks
    head = b.slice_columns(0, 64)
    ok_gadget = PolyMatrix.gadget_matrix(p, 2, dev) @ head.decompose() == head
    del a, b, head

    # small gadget and decomposition, on entries below every q_t
    g = torch.Generator(device=dev).manual_seed(192)
    small = torch.randint(0, min(p.moduli), (2, 4, p.n), generator=g, device=dev)
    m_small = PolyMatrix(small[None].expand(p.crt_depth, 2, 4, p.n).contiguous(), COEFF, p)
    g_small = PolyMatrix.small_gadget_matrix(p, 2, dev)
    dec_small = m_small.small_decompose()
    ok_small = (dec_small.shape == (2 * dpt, 4) and g_small @ dec_small == m_small
                and g_small.mul_decompose_small(m_small) == m_small)

    # tensor-identity products against the materialized I_4 x other
    other = us.sample_uniform(p, 2, 3, uni)
    ident = PolyMatrix.identity(p, 4, device=dev)
    t = us.sample_uniform(p, 1, 8, uni)
    u = us.sample_uniform(p, 1, 4 * 2 * k, uni)
    ok_tensor = (t.mul_tensor_identity(other, 4) == t @ ident.tensor(other)
                 and u.mul_tensor_identity_decompose(other, 4)
                 == u @ ident.tensor(other.decompose()))
    x, y = us.sample_uniform(p, 2, 2, uni), us.sample_uniform(p, 1, 3, uni)
    diag = x.concat_diag([y])
    ok_diag = (diag.shape == (3, 5) and diag.slice(0, 2, 0, 2) == x
               and diag.slice(2, 3, 2, 5) == y
               and not diag.slice(0, 2, 2, 5).data.any() and not diag.slice(2, 3, 0, 2).data.any())
    del other, ident, t, u, x, y, diag

    # hash-decomposed samplers against the decompositions of sample_hash
    hs = HashSampler(device=dev)
    full = hs.sample_hash(p, CORE_KEY, "core", 2, 16, uni)
    ok_hash = (hs.sample_hash_decomposed(p, CORE_KEY, "core", 2, 16, uni) == full.decompose()
               and hs.sample_hash_decomposed_columns(p, CORE_KEY, "core", 2, 16, 4, 8, uni)
               == full.slice_columns(4, 12).decompose()
               and hs.sample_hash_small_decomposed(p, CORE_KEY, "core", 2, 16, uni)
               == full.small_decompose())
    del full

    # Poly round trips
    rng = random.Random(193)
    q = p.modulus
    slots = [rng.randrange(q) for _ in range(p.n)]
    pe = Poly.from_ints_eval(p, slots, dev)
    ok_slots = pe.eval_slots() == slots
    digits = pe.decompose_base()
    ok_digits = (len(digits) == k and p.modulus_digits * p.base_bits >= p.modulus_bits
                 and Poly.from_decomposed(p, digits) == pe)
    bits = [rng.random() < 0.5 for _ in range(p.n)]
    half = Poly.from_int_coeffs(p, [q // 2 * bit for bit in bits], dev).to_eval()
    ok_bits = half.extract_bits_with_threshold() == bits

    # packed bytes of the LWE chain's K_high shape, and files
    m = us.sample_uniform(p, 18, 16, uni)
    compact = m.to_compact_bytes()
    packed, ms_pack = timed(m.to_packed_bytes)
    back, ms_unpack = timed(lambda: PolyMatrix.from_packed_bytes(p, packed, dev))
    ok_packed = back == m and len(packed) == 25 + codec.packed_size(m.data.numel(), p.crt_bits)
    ok_card = back.data.is_cuda and pe.data.is_cuda and dec_small.data.is_cuda
    host, ms_copy = timed(lambda: host_u32(m.data))
    _, ms_codec = timed(lambda: codec.pack_u32(host, p.crt_bits))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_core_") as tmp:
        pe.write_to_file(tmp, "pe")
        m.write_to_file(tmp, "m")
        ok_files = (Poly.read_from_file(p, tmp, "pe", dev) == pe
                    and PolyMatrix.read_from_file(p, tmp, "m", dev) == m)
    torch.cuda.synchronize()
    counts = launch_counts()
    del back, m, host, pe, digits, half

    checks = dict(chunks=ok_chunks, gadget=ok_gadget, small=ok_small, tensor=ok_tensor,
                  diag=ok_diag, hash=ok_hash, slots=ok_slots, digits=ok_digits, bits=ok_bits,
                  packed=ok_packed, files=ok_files, card=ok_card)
    gb = len(compact) / 1e6
    print(f"core ops n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits {p.base_bits}: "
          f"mul_decompose [2, {2 * k}] x G^-1([2, 512]) whole == in chunks of 64 columns "
          f"{ok_chunks}, G G^-1(B) == B {ok_gadget}; small gadget G_s small_G^-1(M) == M and "
          f"mul_decompose_small {ok_small}; mul_tensor_identity(_decompose) == the product "
          f"with I_4 x other {ok_tensor}; concat_diag {ok_diag}; hash-decomposed samplers == "
          f"(small) decompositions of sample_hash {ok_hash}; from_ints_eval/eval_slots "
          f"{ok_slots}, decompose_base/from_decomposed {ok_digits}, "
          f"extract_bits_with_threshold {ok_bits}; packed bytes of [18, 16] round trip "
          f"{ok_packed} ({len(compact)} B compact, {len(packed)} B packed, ratio "
          f"{len(compact) / len(packed):.4f}); .mxxp/.mxxm files {ok_files} (tolerance 0: "
          f"exact); results on the card {ok_card}; launches in the phase: fwd "
          f"{counts['fwd']}, inv {counts['inv']}",
          flush=True)
    timing("core ops: mul_decompose [2, 32] x [2, 512], G^-1 whole", ms_whole, "ms",
           f" (peak {peak_whole / 2**30:.2f} GiB above the allocation before the call)")
    timing("core ops: mul_decompose [2, 32] x [2, 512], chunks of 64 columns", ms_chunks, "ms",
           f" (peak {peak_chunks / 2**30:.2f} GiB above the allocation before the call)")
    timing("core ops: to_packed_bytes [18, 16] (narrow on the card, copy, pack)",
           gb / ms_pack, "GB/s", f" ({ms_pack:.1f} ms for {len(compact)} B of residues; "
           f"narrow + copy alone {ms_copy:.1f} ms, the codec alone {gb / ms_codec:.3f} GB/s, "
           f"{ms_codec:.1f} ms)")
    timing("core ops: from_packed_bytes [18, 16] (unpack, copy, widen on the card)",
           gb / ms_unpack, "GB/s", f" ({ms_unpack:.1f} ms)")
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: core ops check failed: "
                         f"{[name for name, ok in checks.items() if not ok]}")
    require_launches("core ops", counts)
    return counts


# scale^2 / (the dropped 28-bit modulus) must dwarf the rescale's error
# bound: the JAX tests' 2^17 leaves 2^6 at these moduli and misses the
# product by more than 1 (tests/test_torch_ckks.py,
# test_rescale_error_within_its_bound). The scale enters only the host
# encrypt and decrypt: the circuit is the same
CKKS_SCALE = 1 << 24
CKKS_MESSAGES = (3, 5)


def drive_ckks(p, dev, timing, nested: dict) -> dict:
    """One CKKS multiplication, relinearization and rescale at the realistic
    ring, built, saved with `save_circuit`, loaded with `load_circuit` and
    evaluated over constant polys (the JAX tests' mode) on the card; the
    BGG+ sizing that keeps it off BGG+ wires, from the nested phase's
    measured pass time (`nested`). Returns the K1/K2 launch counts."""
    import random
    import tempfile

    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.circuit.serde import circuit_to_json, load_circuit, save_circuit
    from mxx_tpu_torch.gadgets.arith import decode_nested_rns_outputs, encode_nested_rns_value
    from mxx_tpu_torch.gadgets.fhe.ckks import (
        CKKSCiphertext,
        CKKSContext,
        decrypt,
        encrypt,
        sample_relinearization_eval_keys,
    )
    from mxx_tpu_torch.lookup import PolyPltEvaluator
    from mxx_tpu_torch.ring.poly import Poly

    def build():
        circuit = PolyCircuit()
        ctx = CKKSContext(circuit, p, 8, max_unreduced_muls=2, scale=CKKS_SCALE,
                          relinearization_extra_levels=1)
        w1 = CKKSCiphertext.input(ctx, circuit)
        w2 = CKKSCiphertext.input(ctx, circuit)
        ek = CKKSCiphertext.alloc_eval_keys(ctx, circuit)
        prod = w1.mul(w2, ek, circuit)
        scaled = prod.rescale(circuit)
        circuit.output(prod.flatten() + scaled.flatten())
        return circuit, ctx, prod, scaled

    (circuit, ctx, prod, scaled), ms_build = timed(build)
    kinds = circuit.gate_counts()
    n_gates = len(circuit.gates)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckks_") as tmp:
        path = Path(tmp) / "ckks_mul.json"
        _, ms_save = timed(lambda: save_circuit(circuit, path))
        raw = circuit_to_json(circuit)
        size = path.stat().st_size
        loaded, ms_load = timed(lambda: load_circuit(path))
    ok_json = circuit_to_json(loaded) == raw and len(loaded.gates) == n_gates
    loaded.luts.update(circuit.luts)  # the JSON carries LUT ids, not tables

    rng = random.Random(71)
    s = 2
    m1, m2 = CKKS_MESSAGES
    cts = [encrypt(ctx, s, m, rng) for m in (m1, m2)]
    ek_vals = sample_relinearization_eval_keys(ctx, s, rng)
    off, levels, full = ctx.level_offset, ctx.max_active_levels, ctx.nested.q_moduli_depth
    values = [r for ct in cts for v in ct for row in encode_nested_rns_value(
        ctx.nested, v, off, levels) for r in row]
    values += [r for v in ek_vals for row in encode_nested_rns_value(ctx.nested, v, 0, full)
               for r in row]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    inputs = [Poly.const(p, v, dev) for v in values]
    outs, ms_eval = timed(lambda: eval_batched(loaded, p, Poly.one(p, dev), inputs,
                                               PolyPltEvaluator()))
    del inputs
    peak = torch.cuda.max_memory_allocated()
    ok_card = all(o.data.is_cuda for o in outs)
    out_vals, ms_decode = timed(lambda: [o.const_coeff() for o in outs])
    counts = launch_counts()
    del outs

    k = ctx.nested.k

    def ciphertext(pos, lv):
        comps = []
        for _ in range(2):
            rows = [out_vals[pos + i * k:pos + (i + 1) * k] for i in range(lv)]
            comps.append(decode_nested_rns_outputs(ctx.nested, rows, off, lv))
            pos += lv * k
        return comps, pos

    (c0p, c1p), pos = ciphertext(0, prod.active_levels)
    (c0r, c1r), pos = ciphertext(pos, scaled.active_levels)
    removed = ctx.nested.q_moduli[off + prod.active_levels - 1]
    got_prod = decrypt(ctx, s, c0p, c1p, prod.active_levels, scale=CKKS_SCALE**2)
    got_rescaled = decrypt(ctx, s, c0r, c1r, scaled.active_levels,
                           scale=CKKS_SCALE**2 / removed)
    ok_prod = abs(got_prod - m1 * m2) < 0.1
    ok_rescaled = abs(got_rescaled - m1 * m2) < 0.1
    ok_count = pos == len(out_vals) == len(loaded.output_ids)

    # what the same circuit would take over BGG+ wires (d=1): one encoding
    # vector of k polys per wire, and one A_LT per LUT gate at the nested
    # phase's measured rate
    n_inputs = kinds.get("Input", 0)
    n_lut = kinds.get("PubLut", 0)
    wire = p.modulus_digits * p.crt_depth * p.n * 8
    per_lut_ms = nested["ms_pk"] / nested["luts"]
    print(f"ckks n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits {p.base_bits}, p-moduli "
          f"below 2^8 (k = {k}), scale 2^{CKKS_SCALE.bit_length() - 1}, {levels} active levels "
          f"+ {ctx.relin_extra} relinearization level: mul + relinearize + rescale, {n_gates} "
          f"gates {kinds}; JSON {size} B, load(save(c)) == c {ok_json}; the loaded circuit over "
          f"{len(values)} constant inputs on the card {ok_card}: decrypted product "
          f"{got_prod:.6f} within 0.1 of {m1 * m2} {ok_prod}, rescaled {got_rescaled:.6f} "
          f"{ok_rescaled}, {len(out_vals)} outputs {ok_count}; launches in the phase: fwd "
          f"{counts['fwd']}, inv {counts['inv']}", flush=True)
    print(f"ckks over BGG+ wires (not run): {n_inputs} inputs x {wire / 1e6:.2f} MB per "
          f"encoding vector = {n_inputs * wire / 1e9:.2f} GB, {n_lut} A_LT; at the nested rns "
          f"phase's {per_lut_ms:.2f} ms per LUT gate ({nested['luts']} PubLut in a "
          f"{nested['ms_pk'] / 1e3:.2f} s pubkey pass) one pubkey pass projects to "
          f"{n_lut * per_lut_ms / 1e3:.1f} s", flush=True)
    timing(f"ckks: build ({n_gates} gates)", ms_build, "ms")
    timing("ckks: save_circuit", ms_save, "ms", f" ({size} B)")
    timing("ckks: load_circuit", ms_load, "ms")
    timing("ckks: eval of the loaded circuit over constant polys", n_gates / ms_eval * 1e3,
           "gates/s", f" ({ms_eval:.1f} ms; decode {ms_decode:.1f} ms)")
    timing("ckks: peak device memory of the inputs and the eval", (peak - before) / 2**30,
           "GiB", f" above the {before / 2**30:.2f} GiB allocated before them")
    if not all((ok_json, ok_card, ok_prod, ok_rescaled, ok_count)):
        raise SystemExit("chip_smoke: CKKS check failed")
    require_launches("ckks", counts)
    return counts


MONT_MODULUS = 64513  # odd, below 2^16: tests/test_carry_montgomery.py's


def drive_montgomery(p, dev, timing) -> dict:
    """One Montgomery multiplication mod 64513 (4 limbs of 4 bits) over BGG+
    public keys and encodings lifted from the one wire, through
    `lifted_passes`. Returns the K1/K2 launch counts."""
    import random

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.gadgets.arith import CarryArithContext, CarryArithPoly, MontgomeryContext

    circuit = PolyCircuit()
    ctx = CarryArithContext(circuit, p, 4, 4)
    mont = MontgomeryContext(ctx, MONT_MODULUS)
    a = CarryArithPoly.input(ctx, circuit)
    b = CarryArithPoly.input(ctx, circuit)
    prod = mont.mont_mul(a, b, circuit)
    circuit.output(prod.limbs)
    kinds = circuit.gate_counts()
    n_gates = sum(v for g, v in kinds.items() if g != "Input")
    rng = random.Random(13)
    x, y = rng.randrange(MONT_MODULUS), rng.randrange(MONT_MODULUS)
    xm, ym = mont.to_mont_value(x), mont.to_mont_value(y)
    values = CarryArithPoly.encode(ctx, xm) + CarryArithPoly.encode(ctx, ym)
    run = lifted_passes(p, dev, circuit, values, b"montgomery", 201)
    counts = run["counts"]
    got = CarryArithPoly.decode(ctx, [e.plaintext.const_value() for e in run["enc_out"]])
    ok_inputs = (CarryArithPoly.decode(ctx, values[:4]) == x * mont.r % MONT_MODULUS
                 and CarryArithPoly.decode(ctx, values[4:]) == y * mont.r % MONT_MODULUS)
    ok_out = got < 2 * MONT_MODULUS and mont.from_mont_value(got % MONT_MODULUS) == (
        x * y % MONT_MODULUS)
    checks = [run[c] for c in ("ok_lift", "ok_lift_card", "ok_oracle", "ok_keys", "ok_rel")]
    ms_pk, ms_enc = run["ms_pk"], run["ms_enc"]
    print(f"montgomery n={p.n} L={p.crt_depth} d=1 mod {MONT_MODULUS}, 4 limbs of 4 bits "
          f"(R = 2^16): {n_gates} gates {kinds}; inputs are the Montgomery forms of x={x}, "
          f"y={y} {ok_inputs}; output {got} converts back to x y mod N = "
          f"{x * y % MONT_MODULUS} {ok_out}; lifts == large_scalar_mul {checks[0]}, on the card "
          f"{checks[1]}, plaintexts == oracle {checks[2]}, encoding pubkeys == pubkey pass "
          f"{checks[3]}, c == s A - pt (s G) {checks[4]} (tolerance 0: exact); launches in the "
          f"phase: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    timing(f"montgomery: pubkey pass, batched, {n_gates} gates", n_gates / ms_pk * 1e3,
           "gates/s", f" ({ms_pk:.1f} ms)")
    timing(f"montgomery: encoding pass, batched, {n_gates} gates", n_gates / ms_enc * 1e3,
           "gates/s", f" ({ms_enc:.1f} ms)")
    timing("montgomery: peak device memory of lifts and passes", run["peak"] / 2**30, "GiB")
    if not all(checks + [ok_inputs, ok_out]):
        raise SystemExit("chip_smoke: Montgomery multiplication check failed")
    require_launches("montgomery", counts)
    return counts


NTT_SLOTS = 8
NTT_P = 17  # 1 mod 16


def host_ntt(vals, prime, inverse=False):
    """The negacyclic NTT mod `prime` in the ring's order (natural ->
    bit-reversed forward; the inverse with n^-1), on Python ints."""
    from mxx_tpu_torch.utils import numth

    n = len(vals)
    psi = numth.find_primitive_2n_root(prime, n)
    if inverse:
        psi = numth.modinv(psi, prime)
    ln = n.bit_length() - 1
    table = [pow(psi, numth.bit_reverse(i, ln), prime) for i in range(n)]
    x = list(vals)
    if not inverse:
        m, t = 1, n
        while m < n:
            t //= 2
            for i in range(m):
                for j in range(2 * i * t, 2 * i * t + t):
                    u, v = x[j], x[j + t] * table[m + i] % prime
                    x[j], x[j + t] = (u + v) % prime, (u - v) % prime
            m *= 2
        return x
    t, m = 1, n
    while m > 1:
        h = m // 2
        for i in range(h):
            for j in range(2 * i * t, 2 * i * t + t):
                u, v = x[j], x[j + t]
                x[j], x[j + t] = (u + v) % prime, (u - v) * table[h + i] % prime
        t *= 2
        m = h
    n_inv = numth.modinv(n, prime)
    return [v * n_inv % prime for v in x]


def drive_ntt_circuit(p, dev, timing) -> dict:
    """`forward_ntt` then `inverse_ntt` over 8 packed slots mod 17 at the
    realistic ring, over `PolyVec` plaintexts on the card. Returns the K1/K2
    launch counts."""
    import random

    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.circuit.batched_eval import eval_batched
    from mxx_tpu_torch.circuit.poly_vec import PolyVec
    from mxx_tpu_torch.gadgets.ntt_circuit import forward_ntt, inverse_ntt, register_mod_p_lut
    from mxx_tpu_torch.lookup.vec_eval import PolyVecPltEvaluator
    from mxx_tpu_torch.slot_transfer import PolyVecSlotTransferEvaluator

    circuit = PolyCircuit()
    (w,) = circuit.input(1)
    lut = register_mod_p_lut(circuit, p, NTT_P, 2 * NTT_P * NTT_P)
    fwd = forward_ntt(circuit, w, NTT_SLOTS, NTT_P, lut)
    back = inverse_ntt(circuit, fwd, NTT_SLOTS, NTT_P, lut)
    circuit.output([fwd, back])
    kinds = circuit.gate_counts()
    rng = random.Random(12)
    vals = [rng.randrange(NTT_P) for _ in range(NTT_SLOTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs, ms = timed(lambda: eval_batched(
        circuit, p, PolyVec.const(p, [1] * NTT_SLOTS, dev), [PolyVec.const(p, vals, dev)],
        PolyVecPltEvaluator(), PolyVecSlotTransferEvaluator()))
    ok_card = all(x.data.is_cuda for o in outs for x in o.slots)
    got = [[x.const_coeff() for x in o.slots] for o in outs]
    counts = launch_counts()
    want = host_ntt(vals, NTT_P)
    ok_fwd, ok_back = got[0] == want, got[1] == vals
    ok_host = host_ntt(want, NTT_P, inverse=True) == vals
    print(f"ntt circuit n={p.n} L={p.crt_depth}, {NTT_SLOTS} packed slots mod {NTT_P}: "
          f"{kinds}; input {vals}: forward {got[0]} == host NTT mod {NTT_P} {want} {ok_fwd}, "
          f"inverse(forward) == input {ok_back} (host inverse {ok_host}), on the card "
          f"{ok_card} (tolerance 0: exact); launches in the phase: fwd {counts['fwd']}, inv "
          f"{counts['inv']}", flush=True)
    timing(f"ntt circuit: forward + inverse over {NTT_SLOTS} slots", ms, "ms")
    if not all((ok_fwd, ok_back, ok_host, ok_card)):
        raise SystemExit("chip_smoke: in-circuit NTT check failed")
    require_launches("ntt circuit", counts)
    return counts


DIO_LWE_RING = (4, 3, 10, 10)  # tests/test_production_lwe_diamond.py
DIO_NOISE_RING = (256, 3, 24, 5)  # tests/test_noise_regime.py, the packed n=256 run
NO_KERNEL_NOTE = ("no kernel launched: ring/ntt.py sends n < 256 to the radix chain, both "
                  "ways")
K3_ONLY_NOTE = ("K1/K2 not launched: ring/ntt.py sends the forward transforms of "
                "256 <= n < 2048 to K3 and the inverse ones to the radix chain")


def production_prf_config():
    from mxx_tpu_torch.io_protocols.prf_mask import PrfConfig

    # tests/test_production_lwe_diamond.py
    return PrfConfig(seed_bits=2, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                     max_unreduced_muls=1, noise_refresh_v_bits=1, nested_rns_scale=64,
                     debug_encrypt_random_prg_wires=True, debug_reuse_single_material=True,
                     refresh_wire_limit=1)


def first_bit_builder(circuit, bits):
    return [bits[0]]


def k_high_row_bytes(n: int, L: int, crt_bits: int = 28, base_bits: int = 14) -> int:
    """Compact bytes of one d=1 K_high row: a 25-byte header and uint32
    residues [L, k + 2, k, n], k = L ceil(crt_bits / base_bits)."""
    k = L * -(-crt_bits // base_bits)
    return 25 + L * (k + 2) * k * n * 4


def span_line(log, names) -> str:
    return "".join(f"; {label} {log.total_ms(name) / 1e3:.3f} s" for label, name in names)


def drive_diamond_io_lwe(dev, timing) -> dict:
    """Diamond iO over the production LWE LUT evaluators (the default
    factories), in the config of tests/test_production_lwe_diamond.py:
    obfuscate into a temporary directory (the LUT bridge preimage, the
    K_high rows of every recorded LUT gate through the store), evaluate [0]
    and [1] (c_b = s B from the bridge, the stored K_high read back), check
    both decodes, c_one == sigma (A_one - G), B0 lut_bridge == [lut_b; 0]
    and B K_high == target for every stored row of the first LUT gate of
    each plt context, all exact. Returns the K1/K2 launch counts
    ("launches") and the phase's counts and times."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGPublicKeySampler
    from mxx_tpu_torch.io_protocols import DiamondIO
    from mxx_tpu_torch.lookup import lwe
    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.storage import read_matrices_from_multi_batch

    p = RingParams.new(*DIO_LWE_RING)
    dio = DiamondIO(p, input_count=1, batch_bits=1, seed=11, prf_config=production_prf_config(),
                    device=dev)
    # the pubkey evaluator the obfuscation makes, and its gate records from
    # just before `sample_aux_matrices` clears them
    seen = {"in_aux": False}
    cls = lwe.LWEBGGPubKeyPltEvaluator
    sample_aux = cls.sample_aux_matrices

    def recording(self, params):
        seen["eval"], seen["states"] = self, dict(self.gate_state)
        seen["in_aux"] = True
        try:
            return sample_aux(self, params)
        finally:
            seen["in_aux"] = False

    parts: dict = {}
    instrument(dio._trap, "preimage", parts, "trapdoor preimages",
               lambda a, out: (seen["in_aux"], a[3].ncol))
    tmp = Path(tempfile.mkdtemp(prefix="mxx_diamond_io_lwe_"))
    cls.sample_aux_matrices = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SpanLog() as obf_log, HostRssPeak() as rss:
            obf, ms_obf = timed(lambda: dio.obfuscate(tmp, first_bit_builder))
        cls.sample_aux_matrices = sample_aux
        files = [f for f in tmp.iterdir() if f.is_file()]
        nbytes = sum(f.stat().st_size for f in files)
        k_high_files = [f for f in files if f.name.startswith("LWE_K_H_")]
        k_high_bytes = sum(f.stat().st_size for f in k_high_files)
        peak_obf = torch.cuda.max_memory_allocated()
        results = []
        for bits in ([0], [1]):
            torch.cuda.reset_peak_memory_stats()
            with SpanLog() as log:
                out, ms = timed(lambda b=bits: dio.eval(tmp, obf, first_bit_builder, b))
            results.append((bits, out, ms, list(dio.last_decode_margins), log,
                            torch.cuda.max_memory_allocated()))
        counts = launch_counts()

        digits = [1]
        states = dio.injector.online_eval(tmp, obf.preprocess_out, digits)
        sigma = dio.injector.debug_final_secret_matrix(tmp, digits)
        one_pk = BGGPublicKeySampler(obf.hash_key, 1, dev).sample(p, b"diamond_bgg", [True])[0]
        c_one = states[0] @ dio._read(tmp, "one_preimage")
        ok_one = c_one == sigma @ (one_pk.matrix - PolyMatrix.gadget_matrix(p, 1, dev))
        pk_eval = seen["eval"]
        lut_b = pk_eval.pub_matrix
        b0 = obf.preprocess_out.final_checkpoint(0)[1]
        zero = PolyMatrix.zero(p, 1, lut_b.ncol, device=dev)
        ok_bridge = b0 @ dio._read(tmp, "lut_bridge") == lut_b.concat_rows([zero])
        # every stored row of the first gate of each context: B K_high == target
        first: dict = {}
        for key, st in seen["states"].items():
            first.setdefault(key[0], (key, st))
        checked, bad = {}, []
        for ctx, ((_, gate_id, slot), st) in first.items():
            targets = pk_eval._k_high_targets(p, st.plt, st.input_pubkey, st.output_pubkey,
                                              gate_id, st.lut_id, slot, ctx)
            prefix = lwe.k_high_checkpoint_prefix(gate_id, st.lut_id, slot, ctx)
            rows = dict(read_matrices_from_multi_batch(p, tmp, prefix, dev))
            good = 0
            for (_, (kk, _)), t in zip(st.plt.entries(p), targets):
                k_high = rows.get(int(kk))
                if k_high is not None and lut_b @ k_high == t:
                    good += 1
                else:
                    bad.append((ctx, gate_id, int(kk)))
            checked[ctx] = (gate_id, good, st.plt.length)
            del targets, rows
        ok_rows = (not bad and "wrapped" in first and any(c != "wrapped" for c in first))
        torch.cuda.synchronize()
    finally:
        cls.sample_aux_matrices = sample_aux
        shutil.rmtree(tmp, ignore_errors=True)

    ok_dec = all(out == [b[0]] for b, out, *_ in results)
    recorded = seen["states"]
    rows_total = sum(st.plt.length for st in recorded.values())
    contexts: dict = {}
    for (ctx, _, _) in recorded:
        contexts[ctx] = contexts.get(ctx, 0) + 1
    calls = parts["trapdoor preimages"]
    kh = [(ms, cols) for ms, (in_aux, cols) in calls if in_aux]
    other = [(ms, cols) for ms, (in_aux, cols) in calls if not in_aux]
    for bits, out, ms, margins, log, peak in results:
        print(f"diamond io lwe eval {bits}: decoded {out}, want {[bits[0]]}; decode margins "
              f"(distance to the nearest q/2 codeword, of q = {p.modulus}): "
              f"{[m[1] for m in margins]}", flush=True)
    print(f"diamond io lwe n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits "
          f"{p.base_bits}, input_count 1, production LWE LUT evaluators, debug replay: decodes "
          f"{ok_dec}, c_one == sigma (A_one - G) {ok_one}, B0 lut_bridge == [lut_b; 0] "
          f"{ok_bridge}, B K_high == target for every stored row of the first gate of each "
          f"context {ok_rows} ({checked}) (tolerance 0: exact); {len(recorded)} LUT gates "
          f"recorded ({contexts}), {rows_total} K_high rows; launches in the phase: fwd "
          f"{counts['fwd']}, inv {counts['inv']}, K3 {counts['hybrid']} ({NO_KERNEL_NOTE})",
          flush=True)
    print(f"diamond io lwe: preimage calls: K_high {len(kh)} ({sum(c for _, c in kh)} columns, "
          f"{sum(m for m, _ in kh) / 1e3:.3f} s), the others (LUT bridge, rebase, refresh, "
          f"output, decoder) {len(other)} ({sum(c for _, c in other)} columns, "
          f"{sum(m for m, _ in other) / 1e3:.3f} s); artifacts: {len(files)} files, {nbytes} B "
          f"written, of them K_high {len(k_high_files)} files, {k_high_bytes} B (directory "
          f"deleted)", flush=True)
    per_row = k_high_bytes / rows_total
    for n, L in ((4096, 2), (8192, 8)):
        print(f"diamond io lwe: projected K_high bytes at n={n}, L={L} (crt_bits 28, base_bits "
              f"14): {rows_total} rows x {k_high_row_bytes(n, L)} B = "
              f"{rows_total * k_high_row_bytes(n, L) / 1e12:.2f} TB (a lower bound: more limbs "
              f"mean more nested-RNS moduli, more LUT gates and rows; here {per_row:.1f} B per "
              f"row)", flush=True)
    timing("diamond io lwe: obfuscate", ms_obf / 1e3, "s", span_line(obf_log, (
        ("injector preprocess", "diamond_injector.preprocess"),
        ("LUT bridge", "diamond_io.lut_bridge"),
        ("PRF public-key path", "prf_pipeline.pk_round"),
        ("wrapped pubkey pass", "diamond_io.pk_circuit_eval"),
        ("sample_aux_matrices", "lwe_lut.sample_aux_matrices"),
        ("of it lwe_lut.k_high_targets", "lwe_lut.k_high_targets"),
        ("lwe_lut.k_high_preimages", "lwe_lut.k_high_preimages"),
        ("storage.device_to_host", "storage.device_to_host"),
        ("storage.serialize", "storage.serialize"),
        ("wait_for_all_writes", "diamond_io.wait_for_all_writes")))
        + f"; {rss.note()}")
    for bits, out, ms, margins, log, peak in results:
        reads = sum(r.fields["gates"] for r in log.named("lwe_lut.k_high_reads"))
        timing(f"diamond io lwe: eval {bits}", ms / 1e3, "s", span_line(log, (
            ("injector online", "diamond_injector.online_eval"),
            ("LUT bridge encoding", "diamond_io.lut_bridge_encoding"),
            ("PRF encoding path", "prf_pipeline.enc_round"),
            ("wrapped encoding pass", "diamond_io.enc_circuit_eval"),
            ("online K_high reads", "lwe_lut.k_high_reads")))
            + f" ({reads} rows read); peak device memory {peak / 2**30:.3f} GiB")
    timing("diamond io lwe: obfuscate peak device memory", peak_obf / 2**30, "GiB")
    if not (ok_dec and ok_one and ok_bridge and ok_rows):
        raise SystemExit(f"chip_smoke: Diamond iO over the LWE evaluators failed (bad rows "
                         f"{bad[:5]})")
    return {"launches": counts, "obfuscate_ms": ms_obf, "eval_ms": [r[2] for r in results],
            "files": len(files), "bytes": nbytes, "k_high_calls": len(kh),
            "k_high_cols": sum(c for _, c in kh), "rows": rows_total}


def drive_diamond_io_noise(dev, timing) -> dict:
    """Diamond iO with error sigma 4.0 everywhere, packed payload at n=256
    (tests/test_noise_regime.py `test_diamond_io_packed_noise_n256`): 4
    payload slots, trapdoor sigma 4.578, seed 6042, the CI PRF config, the
    debug LUT evaluators, XOR of two bits. Obfuscate into a temporary
    directory, evaluate [0, 1] and [1, 1]; check both decodes and the worst
    observed error in bits within the composed simulated bound
    (`simulate_prf_protocol_error` over `diamond_compose_input_error`,
    replay mode) and at most 80 bits under it. Every decode margin is
    printed against the JAX test's (q // 4) >> 4 and not held: the error of
    this config is q-scale in both packages (it sits at q/4 at L=3 and at
    L=4, and the JAX package's decode fails at n=8), so no run of either
    package meets that margin but by chance. Returns the K1/K2 launch counts
    ("launches") and the times."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.circuit import PolyCircuit
    from mxx_tpu_torch.io_protocols import DiamondIO
    from mxx_tpu_torch.io_protocols.protocol_simulation import (
        diamond_compose_input_error,
        simulate_prf_protocol_error,
    )
    from mxx_tpu_torch.lookup.debug import (
        DebugBGGEncodingPltEvaluator,
        DebugBGGPubKeyPltEvaluator,
    )
    from mxx_tpu_torch.ring.params import RingParams

    p = RingParams.new(*DIO_NOISE_RING)

    def xor_builder(circuit, bits):
        return [circuit.xor_gate(bits[0], bits[1])]

    dio = DiamondIO(
        p, input_count=2, batch_bits=1, seed=6042, error_sigma=ERROR_SIGMA,
        trapdoor_sigma=TRAPDOOR_SIGMA, prf_config=dio_prf_config(), payload_slots=4, device=dev,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(obf.hash_key,
                                         s.injector.debug_final_secret_matrix(d, digits)),
    )
    tmp = Path(tempfile.mkdtemp(prefix="mxx_diamond_io_noise_"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SpanLog() as obf_log:
            obf, ms_obf = timed(lambda: dio.obfuscate(tmp, xor_builder))
        nbytes = dir_bytes(tmp)
        peak_obf = torch.cuda.max_memory_allocated()
        results = []
        for bits in ([0, 1], [1, 1]):
            torch.cuda.reset_peak_memory_stats()
            with SpanLog() as log:
                out, ms = timed(lambda b=bits: dio.eval(tmp, obf, xor_builder, b))
            results.append((bits, out, ms, list(dio.last_decode_margins), log,
                            torch.cuda.max_memory_allocated()))
        counts = launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok_dec = all(out == [b[0] ^ b[1]] for b, out, *_ in results)
    margins = [m for r in results for m in r[3]]
    ok_margins = all(err < (q // 4) >> 4 for _, err, q in margins)
    observed_bits = max(int(err) for _, err, _ in margins).bit_length()
    fn_circuit = PolyCircuit()
    ins = fn_circuit.input(2)
    fn_circuit.output([fn_circuit.xor_gate(ins[0], ins[1])])
    e_enc, worst_state = diamond_compose_input_error(p, dio.injector, TRAPDOOR_SIGMA)
    sim, ms_sim = timed(lambda: simulate_prf_protocol_error(
        p, dio._prf_pipeline(), fn_circuit, input_error_norm=e_enc,
        state_error_norm=worst_state, error_sigma=ERROR_SIGMA, trapdoor_sigma=TRAPDOOR_SIGMA,
        secret_size=dio.secret_size, replay_mode=True))
    bound_bits = sim.total_error_bits
    ok_bound = observed_bits <= bound_bits <= observed_bits + 80
    q = p.modulus
    for bits, out, ms, m, log, peak in results:
        print(f"diamond io noise eval {bits}: decoded {out}, want {[bits[0] ^ bits[1]]}; decode "
              f"errors {[e for _, e, _ in m]} against (q // 4) >> 4 = {(q // 4) >> 4}", flush=True)
    print(f"diamond io noise n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits "
          f"{p.base_bits}, packed payload_slots 4, error sigma {ERROR_SIGMA}, trapdoor sigma "
          f"{TRAPDOOR_SIGMA}, debug replay: decodes {ok_dec}, every margin under (q // 4) >> 4 "
          f"{ok_margins} (not held: q-scale error, {q.bit_length() - 2} bits is q/4, in both "
          f"packages); worst observed error {observed_bits} bits, composed simulated bound "
          f"{bound_bits} bits (replay mode; {ms_sim / 1e3:.3f} s on the host): observed <= bound "
          f"<= observed + 80 {ok_bound}; artifacts {nbytes} B (directory deleted); launches in "
          f"the phase: fwd {counts['fwd']}, inv {counts['inv']}, K3 {counts['hybrid']} "
          f"({K3_ONLY_NOTE})", flush=True)
    timing("diamond io noise: obfuscate", ms_obf / 1e3, "s", span_line(obf_log, (
        ("injector preprocess", "diamond_injector.preprocess"),
        ("PRF public-key path", "prf_pipeline.pk_round_packed"),
        ("of it packed refresh decrypts", "noise_refresh.packed_material_decrypt"),
        ("wrapped pubkey pass", "diamond_io.pk_circuit_eval"))))
    for bits, out, ms, m, log, peak in results:
        timing(f"diamond io noise: eval {bits}", ms / 1e3, "s", span_line(log, (
            ("injector online", "diamond_injector.online_eval"),
            ("PRF encoding path", "prf_pipeline.enc_round_packed"),
            ("of it packed refresh decrypts", "noise_refresh.packed_material_decrypt"),
            ("wrapped encoding pass", "diamond_io.enc_circuit_eval")))
            + f"; peak device memory {peak / 2**30:.3f} GiB")
    timing("diamond io noise: obfuscate peak device memory", peak_obf / 2**30, "GiB",
           f"; artifacts {nbytes} B")
    if not (ok_dec and ok_bound):
        raise SystemExit("chip_smoke: Diamond iO noise check failed")
    if counts["hybrid"] == 0:
        raise SystemExit("chip_smoke: the diamond io noise phase did not go through K3")
    return {"launches": counts, "obfuscate_ms": ms_obf, "eval_ms": [r[2] for r in results],
            "observed_bits": observed_bits, "bound_bits": bound_bits}


DIO_REAL_RING = (2, 2, 9, 9)  # tests/test_diamond_io.py `test_diamond_io_real_mode_e2e`


def real_prf_config():
    from mxx_tpu_torch.io_protocols.prf_mask import PrfConfig

    # tests/test_diamond_io.py `test_diamond_io_real_mode_e2e`: no debug flag,
    # every wire refreshed, PRG-derived refresh material
    return PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=8,
                     max_unreduced_muls=2, noise_refresh_v_bits=1, p_basis="wide",
                     debug_encrypt_random_prg_wires=False, debug_reuse_single_material=False,
                     refresh_wire_limit=None)


def circuit_shape(circuit) -> str:
    from mxx_tpu_torch.circuit.arena_eval import plan

    levels = len({depth for _, depth, _ in plan(circuit).groups})
    return f"{circuit.num_gates()} gates in {levels} levels"


def drive_diamond_io_real(dev, timing) -> dict:
    """Real-mode Diamond iO at the config of the JAX package's
    `test_diamond_io_real_mode_e2e`: RingParams.new(2, 2, 9, 9), no debug
    flag (the Goldreich PRG round runs in-circuit over the seed ciphertexts'
    wires, the refresh material comes from in-circuit PRG streams, every wire
    is refreshed), input_count 1, batch_bits 1, seed 7, error sigma 0,
    trapdoor sigma 4.578, the debug LUT evaluators, builder [bits[0]].
    Obfuscate into a temporary directory, evaluate [0] and [1], delete it.
    Checks, all exact: both decodes; no PRG ciphertext in the obfuscation;
    c_one == sigma (A_one - G); B0 P == target for every rebase and refresh
    preimage of branch 0 (targets captured at the calls); the online PRG
    wires' public keys equal the offline pass's of the selected branch.
    Returns the K1/K2/K3 launch counts ("launches") and the times."""
    import shutil
    import tempfile

    import torch

    from mxx_tpu_torch.bgg import BGGPublicKeySampler
    from mxx_tpu_torch.io_protocols import DiamondIO
    from mxx_tpu_torch.io_protocols.prf_mask import PrfMaskPipeline
    from mxx_tpu_torch.lookup.debug import (
        DebugBGGEncodingPltEvaluator,
        DebugBGGPubKeyPltEvaluator,
    )
    from mxx_tpu_torch.matrix import PolyMatrix, rows
    from mxx_tpu_torch.noise_refresh.naive_vec import NoiseRefresherNaiveVec
    from mxx_tpu_torch.ring.params import RingParams

    p = RingParams.new(*DIO_REAL_RING)
    dio = DiamondIO(
        p, input_count=1, batch_bits=1, seed=7, trapdoor_sigma=TRAPDOOR_SIGMA,
        prf_config=real_prf_config(), device=dev,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(obf.hash_key,
                                         s.injector.debug_final_secret_matrix(d, digits)),
    )
    # the PRF pipeline's preimage calls (targets and preimages, in call order:
    # per branch its rebase call, then its refresh call) and its PRG rounds
    calls, rounds, built = [], [], []
    cls = PrfMaskPipeline
    orig_pre, orig_round = cls._preimages, cls._eval_prg_round
    orig_build, orig_material = cls.build_prg_round_circuit, NoiseRefresherNaiveVec._prg_material_circuit

    def preimages(self, td0, b0, targets):
        out = orig_pre(self, td0, b0, targets)
        calls.append((targets, out))
        return out

    def prg_round(self, round_idx, one_wire, seed_wires, plt_evaluator, only_branch=None):
        out = orig_round(self, round_idx, one_wire, seed_wires, plt_evaluator, only_branch)
        rounds.append((only_branch, [w for chunk in out[only_branch] for w in chunk]))
        return out

    # the shape of each circuit the obfuscation builds, taken where it is built
    # (the pipeline keeps no circuit)
    def build_round(self, round_idx, only_branch=None, representative=False):
        c = orig_build(self, round_idx, only_branch, representative)
        built.append((f"PRG round, branch {only_branch}", circuit_shape(c)))
        return c

    def build_material(self, graph_seed, seed_bits, cbd_n):
        c = orig_material(self, graph_seed, seed_bits, cbd_n)
        built.append(("refresh material", circuit_shape(c)))
        return c

    parts: dict = {}
    instrument(dio._trap, "preimage_batched_sharded", parts, "preimage calls",
               lambda a, out: sum(t.ncol for t in a[3]))
    tmp = Path(tempfile.mkdtemp(prefix="mxx_diamond_io_real_"))
    cls._preimages, cls._eval_prg_round = preimages, prg_round
    cls.build_prg_round_circuit = build_round
    NoiseRefresherNaiveVec._prg_material_circuit = build_material
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SpanLog() as obf_log, HostRssPeak() as rss:
            obf, ms_obf = timed(lambda: dio.obfuscate(tmp, first_bit_builder))
        files = [f for f in tmp.iterdir() if f.is_file()]
        nbytes = sum(f.stat().st_size for f in files)
        peak_obf = torch.cuda.max_memory_allocated()
        n_pre_calls = len(parts["preimage calls"])
        pre_cols = sum(c for _, c in parts["preimage calls"])
        offline = {b: wires for b, wires in rounds}
        shapes = {}
        for label, shape in built:
            if label == "refresh material":
                label = f"refresh material, branch {sum(k.startswith(label) for k in shapes)}"
            shapes[label] = shape
        results = []
        for bits in ([0], [1]):
            torch.cuda.reset_peak_memory_stats()
            del rounds[:]
            with SpanLog() as log, HostRssPeak() as eval_rss:
                out, ms = timed(lambda b=bits: dio.eval(tmp, obf, first_bit_builder, b))
            # the online PRG wires' public keys against the offline pass's
            (branch, online), = rounds
            ok_pk = len(online) == len(offline[branch]) and torch.equal(
                rows.stack(p, [w.pubkey.matrix for w in online]),
                rows.stack(p, [w.matrix for w in offline[branch]]))
            results.append((bits, out, ms, log, torch.cuda.max_memory_allocated(), ok_pk,
                            eval_rss.note()))
        counts = launch_counts()
        digits = [1]
        states = dio.injector.online_eval(tmp, obf.preprocess_out, digits)
        sigma = dio.injector.debug_final_secret_matrix(tmp, digits)
        one_pk = BGGPublicKeySampler(obf.hash_key, 1, dev).sample(p, b"diamond_bgg", [True])[0]
        c_one = states[0] @ dio._read(tmp, "one_preimage")
        ok_one = c_one == sigma @ (one_pk.matrix - PolyMatrix.gadget_matrix(p, 1, dev))
        # B0 P == target for every rebase and refresh preimage of branch 0
        b0 = obf.preprocess_out.final_checkpoint(0)[1]
        checked = 0
        ok_pre = len(calls) == 4
        for targets, pres in calls[:2]:
            got = rows.matmul_left(p, b0, rows.stack(p, pres).transpose(0, 1))
            ok_pre = ok_pre and torch.equal(got, rows.stack(p, targets))
            checked += len(targets)
        torch.cuda.synchronize()
    finally:
        cls._preimages, cls._eval_prg_round = orig_pre, orig_round
        cls.build_prg_round_circuit = orig_build
        NoiseRefresherNaiveVec._prg_material_circuit = orig_material
        shutil.rmtree(tmp, ignore_errors=True)

    prf = dio._prf_pipeline()
    ok_dec = all(out == [b[0]] for b, out, *_ in results)
    ok_replay = obf.prf_debug is None or not obf.prf_debug.prg_cts
    ok_pks = all(r[5] for r in results)
    wires = len(offline[0])
    wrapped = [r.fields["gates"] for r in obf_log.named("diamond_io.pk_circuit_eval")]
    shapes["wrapped"] = f"{wrapped[0]} gates"
    print(f"diamond io real n={p.n} L={p.crt_depth} crt_bits {p.crt_bits} base_bits "
          f"{p.base_bits}, real mode (in-circuit PRG rounds, PRG-derived refresh material, "
          f"every wire refreshed), wide p-basis of {len(prf.ctx.nested.p_moduli)} moduli below "
          f"2^8, {prf.wires_per_ct} wires per GSW ciphertext, {wires} PRG output wires per "
          f"branch: circuits {shapes}", flush=True)
    for bits, out, ms, log, peak, ok_pk, note in results:
        print(f"diamond io real eval {bits}: decoded {out}, want {[bits[0]]}; online PRG wires' "
              f"public keys == the offline pass's of branch {bits[0]} {ok_pk}", flush=True)
    print(f"diamond io real: decodes {ok_dec}, no PRG ciphertext in the obfuscation "
          f"{ok_replay}, c_one == sigma (A_one - G) {ok_one}, B0 P == target for every rebase "
          f"and refresh preimage of branch 0 {ok_pre} ({checked} preimages), online PRG "
          f"public keys == offline {ok_pks} (tolerance 0: exact); preimage calls {n_pre_calls} "
          f"({pre_cols} columns); artifacts {len(files)} files, {nbytes} B (directory deleted); "
          f"launches in the phase: fwd {counts['fwd']}, inv {counts['inv']}, K3 "
          f"{counts['hybrid']} ({NO_KERNEL_NOTE})", flush=True)

    def rates(log) -> str:
        out = []
        for label, name in (("PRG round", "prf_pipeline.prg_round_circuit"),
                            ("refresh material", "noise_refresh.prg_material_circuit"),
                            ("wrapped", "diamond_io.pk_circuit_eval"),
                            ("wrapped", "diamond_io.enc_circuit_eval")):
            recs = log.named(name)
            if recs:
                g = sum(r.fields["gates"] for r in recs)
                ms = sum(r.ms for r in recs)
                out.append(f"{label} {g / ms * 1e3:.0f} gates/s ({g} gates, {ms / 1e3:.3f} s)")
        return "; gates/s per pass: " + ", ".join(out)

    timing("diamond io real: obfuscate", ms_obf / 1e3, "s", span_line(obf_log, (
        ("injector preprocess", "diamond_injector.preprocess"),
        ("PRF public-key path", "prf_pipeline.pk_round"),
        ("of it PRG round builds", "prf_pipeline.prg_round_build"),
        ("PRG round passes", "prf_pipeline.prg_round_circuit"),
        ("refresh material builds", "noise_refresh.prg_material_build"),
        ("refresh material passes", "noise_refresh.prg_material_circuit"),
        ("rebase targets", "prf_pipeline.rebase_targets"),
        ("refresh targets", "prf_pipeline.refresh_targets"),
        ("preimages", "prf_pipeline.preimages"),
        ("writes", "prf_pipeline.writes"),
        ("wrapped pubkey pass", "diamond_io.pk_circuit_eval"))) + rates(obf_log)
        + f"; {rss.note()}")
    for bits, out, ms, log, peak, ok_pk, note in results:
        timing(f"diamond io real: eval {bits}", ms / 1e3, "s", span_line(log, (
            ("injector online", "diamond_injector.online_eval"),
            ("PRF encoding path", "prf_pipeline.enc_round"),
            ("of it PRG round build", "prf_pipeline.prg_round_build"),
            ("PRG round pass", "prf_pipeline.prg_round_circuit"),
            ("refresh material build", "noise_refresh.prg_material_build"),
            ("refresh material pass", "noise_refresh.prg_material_circuit"),
            ("rebase", "prf_pipeline.rebase_online"),
            ("reads", "prf_pipeline.reads"),
            ("refresh", "prf_pipeline.refresh_online"),
            ("wrapped encoding pass", "diamond_io.enc_circuit_eval"))) + rates(log)
            + f"; peak device memory {peak / 2**30:.3f} GiB; {note}")
    timing("diamond io real: obfuscate peak device memory", peak_obf / 2**30, "GiB")
    if not (ok_dec and ok_replay and ok_one and ok_pre and ok_pks):
        raise SystemExit("chip_smoke: real-mode Diamond iO failed its checks")
    return {"launches": counts, "obfuscate_ms": ms_obf, "eval_ms": [r[2] for r in results],
            "files": len(files), "bytes": nbytes}


PROD_DIRECT_N = 65536  # the production rows' ring degree, run directly
PROD_DIRECT_COLS = (2, 4)  # its columns: the second only if its peak is predicted to fit
PROD_PEAK_LIMIT = 60 * 2**30  # bytes of device memory the direct run may take


def drive_production_ring(dev, timing) -> dict:
    """The main path at the production depth (L=53, crt_bits 28, base_bits
    14, d=1, sigma 4.578): the security-100 table's preimage anchors (8 cols
    at n=2^13 and 2^14) and the preimage directly at n=2^16, each through
    `measure_preimage` (a warm-up and two timed calls, B x == U checked
    after every call), with the K1/K2/K3 counters reset before each ring and
    read after it, and the peak device memory of each; then the table's rows
    from the measured anchors, written to the CSV under build/. Returns the
    per-ring and total launches, the anchors, the rows and the shapes of the
    largest transforms (for the kernel rows)."""
    import torch

    from mxx_tpu_torch.ops import hybrid_ntt
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.scripts import security100_parameter_table as table

    depth, d = table.ANCHOR_DEPTH, table.ANCHOR_D

    def run(n, cols):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        res = table.measure_preimage(n, depth, d, cols, dev)
        torch.cuda.synchronize()
        res.update(counts=launch_counts(), seconds=time.perf_counter() - t0, base=base,
                   peak=torch.cuda.max_memory_allocated() - base)
        c = res["counts"]
        timing(f"production ring: preimage n={n} L={depth} d={d} cols={cols}",
               res["cols_per_s"], "preimage-cols/s",
               f" (calls {', '.join(f'{ms:.1f}' for ms in res['call_ms'])} ms; B x == U after "
               f"each of 3 calls; peak device memory {res['peak'] / 2**30:.3f} GiB above the "
               f"phase's start, {res['held_bytes'] / 2**30:.3f} GiB held by trapdoor, target "
               f"and operands; route fwd {ntt.fwd_route(dev.type, n).upper()}; launches K1 "
               f"{c['fwd']}, K2 {c['inv']}, K3 {c['hybrid']} over trapdoor, 3 calls and checks; "
               f"{res['seconds']:.1f} s with the trapdoor)")
        return res

    anchors, per_ring = {}, {}
    for n in table.ANCHOR_RINGS:
        res = run(n, table.ANCHOR_COLS)
        if res["counts"]["fwd"] == 0 or res["counts"]["inv"] == 0:
            raise SystemExit(f"chip_smoke: the production ring at n={n} did not go through K1 "
                             "and K2")
        anchors[n] = res["cols_per_s"]
        per_ring[n] = res["counts"]

    extrapolated = table.extrapolated_cols_per_s(anchors)
    params = {n: RingParams.new(n, depth, table.CRT_BITS, table.BASE_BITS)
              for n in (max(table.ANCHOR_RINGS), PROD_DIRECT_N)}
    plan = hybrid_ntt.launch_plan(PROD_DIRECT_N, 1, max(params[PROD_DIRECT_N].moduli))
    direct_cols = PROD_DIRECT_COLS[0]
    res = run(PROD_DIRECT_N, direct_cols)
    # the body (all but what the trapdoor holds) grows with the columns
    body = res["peak"] - res["held_bytes"]
    predicted = res["base"] + res["held_bytes"] + body * PROD_DIRECT_COLS[1] // direct_cols
    fits = predicted < PROD_PEAK_LIMIT
    print(f"production ring: n={PROD_DIRECT_N} at {PROD_DIRECT_COLS[1]} cols would peak at "
          f"{predicted / 2**30:.3f} GiB (scaled from {direct_cols} cols); limit "
          f"{PROD_PEAK_LIMIT / 2**30:.0f} GiB: {'run' if fits else 'not run'}", flush=True)
    if fits:
        direct_cols = PROD_DIRECT_COLS[1]
        res = run(PROD_DIRECT_N, direct_cols)
    if res["counts"]["hybrid"] == 0:
        raise SystemExit(f"chip_smoke: the production ring at n={PROD_DIRECT_N} did not go "
                         "through K3")
    per_ring[PROD_DIRECT_N] = res["counts"]
    timing(f"production ring: preimage n={PROD_DIRECT_N} L={depth} cols={direct_cols}, measured",
           res["cols_per_s"], "preimage-cols/s",
           f" beside {extrapolated:.4f} extrapolated from the anchors (measured / extrapolated "
           f"{res['cols_per_s'] / extrapolated:.3f}); K3 over a cluster of {plan.cluster} "
           f"blocks forward, the radix chain inverse")

    rows = table.table_rows(anchors, dev)
    for row in rows:
        print(f"production ring: table row {json.dumps(row)}", flush=True)
    note = (f"measured on the card ({card_line()}) by chip_smoke.py: d={d}, "
            f"{table.ANCHOR_COLS} cols, L={depth}, "
            + ", ".join(f"n={n} {c!r} cols/s" for n, c in anchors.items()))
    table.write_csv(rows, note, table.DEFAULT_OUT)
    print(f"production ring: wrote {table.DEFAULT_OUT}", flush=True)

    k = params[PROD_DIRECT_N].modulus_digits
    return {"per_ring": per_ring, "anchors": anchors, "rows": rows,
            "launches": {key: sum(c[key] for c in per_ring.values())
                         for key in ("fwd", "inv", "hybrid")},
            "anchor_params": params[max(table.ANCHOR_RINGS)],
            "anchor_polys": d * k * table.ANCHOR_COLS,
            # the kernel row's shape is the first direct run's: a larger one
            # with its plain version and chain beside it would not fit
            "direct_params": params[PROD_DIRECT_N], "direct_polys": d * k * PROD_DIRECT_COLS[0]}


MESH_REQUESTS = (17, 17, 16)  # the bench preimage's 50 columns as three requests
MESH_PRE_RING = (16384, 10, 24, 12)  # phase 4's ring
MESH_RING = (8192, 8, 28, 14)  # the limb x column, switch and LWE chain ring
MESH_MODULI = (2, 251, 1 << 16)
MIXED_REQUESTS = (3, 2)  # the card-and-host mesh's preimage requests, at MESH_RING


def drive_mesh(dev, timing, lwe_ms) -> dict:
    """`parallel/` and the mesh-sharded preimage on the card: the real mesh
    of `make_mesh()` (1x1 on a one-card machine) and logical meshes whose
    shards all sit on `dev`. Returns the K1/K2 counts of the 1x4 sharded
    preimage and of the LWE chain over the 1x4 mesh."""
    import numpy as np
    import torch

    from mxx_tpu_torch.matrix import PolyMatrix
    from mxx_tpu_torch.ops.zq_matmul import zq_matmul
    from mxx_tpu_torch.parallel import (
        LIMB_AXIS,
        Mesh,
        Sharding,
        crt_switch_sharded,
        make_mesh,
        matrix_sharding,
        table_sharding,
    )
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.ring.poly import COEFF
    from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler, chacha
    from mxx_tpu_torch.utils import tracing
    from mxx_tpu_torch.sampler.trapdoor import _preimage_core, preimage_smoothing_parameter

    t_phase = time.perf_counter()
    card_mesh = make_mesh(device=dev)
    m14 = Mesh([[dev] * 4])
    m24 = Mesh([[dev] * 4] * 2)
    print(f"mesh: torch.cuda.device_count() {torch.cuda.device_count()}", flush=True)
    for name, m in (("make_mesh()", card_mesh), ("logical 1x4", m14), ("logical 2x4", m24)):
        print(f"mesh: {name}: shape {m.shape}, shards on "
              f"{[[str(d) for d in row] for row in m.devices]}", flush=True)
    if card_mesh.size != torch.cuda.device_count():
        raise SystemExit("chip_smoke: make_mesh() does not hold one shard per card")

    # the sharded preimage at the bench shape
    pp = RingParams.new(*MESH_PRE_RING)
    ts = TrapdoorSampler(pp, 4.578, seed=2, device=dev)
    twin = TrapdoorSampler(pp, 4.578, seed=2, device=dev)
    td, a = ts.trapdoor(pp, 1)
    us = UniformSampler(seed=3, device=dev)
    targets = [us.sample_uniform(pp, 1, w, FinRingDist()) for w in MESH_REQUESTS]
    got = ts.preimage_batched_sharded(pp, td, a, targets, mesh=card_mesh)
    want = twin.preimage_batched_sharded(pp, td, a, targets)
    same_card = all(torch.equal(g.data, w.data) for g, w in zip(got, want))
    del got, want
    torch.cuda.synchronize()
    reset_launches()
    xs = ts.preimage_batched_sharded(pp, td, a, targets, mesh=m14)
    torch.cuda.synchronize()
    counts = launch_counts()
    exact = all(x.ncol == t.ncol and (a @ x) == t for x, t in zip(xs, targets))
    total = sum(MESH_REQUESTS)
    width = -(-total // 4)
    combined = targets[0].to_eval().concat_columns(targets[1:])
    padded = combined.concat_columns([combined.slice_columns(total - 1, total)]
                                     * (4 * width - total))
    out = xs[0].concat_columns(xs[1:]).data
    del xs
    s = preimage_smoothing_parameter(ts.base, ts.sigma, 1, pp.n, pp.modulus_digits)
    ops = ts._operands(td, a, s)
    call_key = chacha.fold_in(ts._key, ts._ctr)
    shard_err = 0
    for j in range(4):
        ref = _preimage_core(pp, chacha.fold_in(call_key, j),
                             padded.slice_columns(j * width, (j + 1) * width), *ops,
                             sigma=ts.sigma, c=ts.c, s=s).data
        cols = min(width, total - j * width)
        shard_err = max(shard_err, max_err(out[:, :, j * width:j * width + cols],
                                           ref[:, :, :cols]))
    del out, ref
    print(f"mesh: preimage n={pp.n} L={pp.crt_depth} d=1, requests {list(MESH_REQUESTS)}: make_mesh() "
          f"{card_mesh.shape} == unsharded call {same_card}; logical 1x4 ({total} -> "
          f"{4 * width} columns, {width} per shard): A x == U per request {exact}, max |shard "
          f"- _preimage_core under fold_in(key, j)| {shard_err} (tolerance 0); launches in "
          f"the 1x4 call: fwd {counts['fwd']}, inv {counts['inv']}", flush=True)
    if not (same_card and exact and shard_err == 0):
        raise SystemExit("chip_smoke: sharded preimage check failed")
    require_launches("mesh", counts)
    ms_1x4 = cuda_ms(lambda: ts.preimage_batched_sharded(pp, td, a, targets, mesh=m14), 3)
    ms_card = cuda_ms(lambda: ts.preimage_batched_sharded(pp, td, a, targets, mesh=card_mesh), 3)
    ms_one = cuda_ms(lambda: ts.preimage_batched_sharded(pp, td, a, targets), 3)
    timing("mesh: preimage 50 cols over the logical 1x4 mesh", ms_1x4, "ms per call",
           f" ({ms_1x4 / ms_one:.2f}x the unsharded call's {ms_one:.1f} ms; make_mesh() "
           f"{card_mesh.shape}: {ms_card:.1f} ms)")
    del ts, twin, td, a, targets, combined, padded, ops
    torch.cuda.empty_cache()

    # limb x column sharding over the logical 2x4 mesh
    p = RingParams.new(*MESH_RING)
    t = p.tables(dev)
    am, bm = residues(p, (2, 4), 11, dev), residues(p, (4, 8), 12, dev)
    sa = matrix_sharding(m24).split(am)
    sb = matrix_sharding(m24, shard_cols=True).split(bm)
    sq = table_sharding(m24).split(t.moduli)
    mm = matrix_sharding(m24, shard_cols=True).join(
        [[zq_matmul(sa[i][j], sb[i][j], sq[i][j]) for j in range(4)] for i in range(2)])
    mm_err = max_err(mm, zq_matmul(am, bm, t.moduli))
    x = residues(p, (64,), 13, dev)
    limbs = Sharding(m24, (LIMB_AXIS,))
    sx, sp, sl = limbs.split(x), limbs.split(t.psi_rev), limbs.split(t.moduli)
    # a limb shard holds 4 of the 8 limbs: it takes the radix chain with its
    # own limbs' tables (K1 takes all L limbs' tables)
    fwd = limbs.join([[ntt.ntt_fwd(sx[i][j], sp[i][j], sl[i][j]) for j in range(4)]
                      for i in range(2)])
    ntt_err = max(max_err(fwd, ntt.ntt_fwd(x, t.psi_rev, t.moduli)),
                  max_err(fwd, ntt.ntt_fwd_auto(x, p)))
    print(f"mesh: logical 2x4, n={p.n} L={p.crt_depth}: zq_matmul [2, 4] x [4, 8] limb + "
          f"column sharded, max |sharded - unsharded| {mm_err}; ntt_fwd of {list(x.shape)} "
          f"limb sharded, max |sharded - unsharded (radix chain, and ntt_fwd_auto: K1 on the "
          f"card)| {ntt_err} (tolerance 0)", flush=True)
    if mm_err or ntt_err:
        raise SystemExit("chip_smoke: limb x column sharding check failed")
    del am, bm, sa, sb, sq, mm, x, sx, sp, sl, fwd

    # crt_switch_sharded over the logical 2x4 mesh
    q = p.modulus
    data = residues(p, (2, 512), 14, dev)
    m = PolyMatrix(data, COEFF, p)
    flat = data.reshape(p.crt_depth, -1)
    sample = torch.from_numpy(np.random.default_rng(15).choice(flat.shape[1], 4096,
                                                               replace=False)).to(dev)
    host = flat[:, sample].cpu().numpy()
    coeffs = [p.reconstruct_coeff(host[:, k]) for k in range(host.shape[1])]
    for P in MESH_MODULI:
        got = crt_switch_sharded(p, data, P, m24)
        mism_ms = int((got != m.modulus_switch(P).data[0]).sum())  # P is below every q_t
        exact = np.array([(c * P + q // 2) // q % P for c in coeffs], dtype=np.int64)
        mism_exact = int((got.reshape(-1)[sample].cpu().numpy() != exact).sum())
        # the JAX package's order, for comparison: independent per-limb-shard
        # partials (each shard's limbs in order), added at the end
        fracs = p.ms_tables(P)[1]
        parts = []
        for i in range(2):
            acc = torch.zeros(data.shape[1:], dtype=torch.float64, device=dev)
            for limb in range(4 * i, 4 * i + 4):
                acc = acc + data[limb].to(torch.float64) * float(fracs[limb])
            parts.append(acc)
        seq = torch.zeros(data.shape[1:], dtype=torch.float64, device=dev)
        for limb in range(p.crt_depth):
            seq = seq + data[limb].to(torch.float64) * float(fracs[limb])

        def rounded(fr):
            return torch.floor(fr) + (fr - torch.floor(fr) >= 0.5).to(torch.float64)

        flips = int((rounded(parts[0] + parts[1]) != rounded(seq)).sum())
        del parts, seq
        ms_sw = cuda_ms(lambda: crt_switch_sharded(p, data, P, m24), 5)
        ms_ms = cuda_ms(lambda: m.modulus_switch(P), 5)
        print(f"mesh: crt_switch_sharded P={P} over the logical 2x4 mesh, [2, 512] at "
              f"n={p.n} L={p.crt_depth} ({got.numel()} coefficients): {mism_ms} mismatches against "
              f"PolyMatrix.modulus_switch, {mism_exact} of {len(coeffs)} sampled coefficients "
              f"against the exact big-int rule (tolerance 0); independent per-shard partials "
              f"would round {flips} coefficients otherwise", flush=True)
        timing(f"mesh: crt_switch_sharded P={P} [2, 512] n={p.n} L={p.crt_depth}, logical 2x4",
               ms_sw,
               "ms per call", f" (PolyMatrix.modulus_switch {ms_ms:.3f} ms)")
        if mism_ms or mism_exact:
            raise SystemExit(f"chip_smoke: crt_switch_sharded P={P} check failed")
        del got
    del data, m, flat
    torch.cuda.empty_cache()

    # a mesh of two distinct devices, the card and the host: operands, keys,
    # column shards and limb shards are copied between them and gathered back
    cpu = torch.device("cpu")
    mixed = Mesh([[dev, cpu]])
    ts = TrapdoorSampler(p, 4.578, seed=4, device=dev)
    td, a = ts.trapdoor(p, 1)
    us = UniformSampler(seed=5, device=dev)
    targets = [us.sample_uniform(p, 1, w, FinRingDist()) for w in MIXED_REQUESTS]
    xs = ts.preimage_batched_sharded(p, td, a, targets, mesh=mixed)
    exact = all(x.ncol == t.ncol and x.data.device == a.data.device and (a @ x) == t
                for x, t in zip(xs, targets))
    total = sum(MIXED_REQUESTS)
    width = -(-total // 2)
    combined = targets[0].to_eval().concat_columns(targets[1:])
    padded = combined.concat_columns([combined.slice_columns(total - 1, total)]
                                     * (2 * width - total))
    out = xs[0].concat_columns(xs[1:]).data
    s = preimage_smoothing_parameter(ts.base, ts.sigma, 1, p.n, p.modulus_digits)
    call_key = chacha.fold_in(ts._key, ts._ctr)
    shard_err = 0
    for j, shard_dev in enumerate((dev, cpu)):
        shard = padded.slice_columns(j * width, (j + 1) * width)
        ref = _preimage_core(p, chacha.fold_in(call_key.to(shard_dev), j),
                             PolyMatrix(shard.data.to(shard_dev), shard.fmt, p),
                             *ts._operands(td, a, s, shard_dev), sigma=ts.sigma, c=ts.c,
                             s=s).data
        cols = min(width, total - j * width)
        shard_err = max(shard_err, max_err(out[:, :, j * width:j * width + cols],
                                           ref[:, :, :cols].to(dev)))
    data = residues(p, (2, 512), 16, dev)
    m = PolyMatrix(data, COEFF, p)
    switch_err = 0
    for order in ([dev, cpu], [cpu, dev]):
        for P in MESH_MODULI:
            got = crt_switch_sharded(p, data, P, Mesh([[d] for d in order]))
            switch_err = max(switch_err, max_err(got.to(dev), m.modulus_switch(P).data[0]))
    print(f"mesh: the card and the host, {mixed.shape}: preimage n={p.n} L={p.crt_depth} d=1, "
          f"requests {list(MIXED_REQUESTS)}: A x == U per request, gathered on the card "
          f"{exact}, max |shard - _preimage_core on the shard's device| {shard_err}; "
          f"crt_switch_sharded over 2x1 (card, host) and (host, card), P in "
          f"{list(MESH_MODULI)}: max |sharded - modulus_switch| {switch_err} (tolerance 0)",
          flush=True)
    if not exact or shard_err or switch_err:
        raise SystemExit("chip_smoke: the card-and-host mesh check failed")
    del ts, td, a, targets, xs, combined, padded, out, ref, data, m
    torch.cuda.empty_cache()

    # the LWE LUT chain's offline K_high phase over the logical 1x4 mesh
    label = "mesh: lwe lut chain over a logical 1x4 mesh"
    lut_counts, lut_mesh_ms = drive_lwe_lut(p, dev, timing, mesh=m14, label=label)
    for name in ("sample_aux_matrices", "K_high preimages"):
        timing(f"{label}: {name} beside the unsharded chain", lut_mesh_ms[name], "ms",
               f" ({lut_mesh_ms[name] / lwe_ms[name]:.2f}x the unsharded chain's "
               f"{lwe_ms[name]:.1f} ms)")
    timing("mesh: the whole phase", (time.perf_counter() - t_phase) * 1e3, "ms")
    return {"preimage": counts, "lwe": lut_counts}


K3_ROWS = (((32768, 10, 24, 12), 500), ((65536, 10, 24, 12), 250), ((256, 3, 24, 5), 4096))
K1_K3_TURNS = (((16384, 10, 24, 12), 1000), ((8192, 8, 28, 14), 512))


def kernel_row(c: dict, timing, radix_err: int, at_a: dict) -> dict:
    """One row of the kernels line: case `c`'s kernel against its plain
    version, the radix chain and (where given) K1, bit for bit, then its
    time (median of 10), bounds, plain and chain times."""
    name, source, run, plain, chain = c["name"], c["source"], c["run"], c["plain"], c["chain"]
    got = run()
    err = max_err(got, plain())
    full = c["then"](got) if "then" in c else got
    err = max(err, max_err(full, chain()))
    if c.get("k1") is not None:
        err = max(err, max_err(full, c["k1"]()))
    if source == "radix_ntt.cu":
        err = max(err, radix_err)
    del got, full
    ms = cuda_ms(run, 10)
    ms_plain = cuda_ms(plain, c["plain_iters"])
    ms_chain = cuda_ms(chain, 3)
    shape = list(c["x"].shape)
    bound = ntt_bound(shape, c["products"])
    entry = {"name": name, "route": "cuda", "source": f"mxx_tpu_torch/csrc/{source}",
             "replaces": c["replaces"], "launches": c["launches"], "max_abs_err": err,
             "ms": ms, "plain_ms": ms_plain, "bound_ms": bound["bound_ms"],
             "bound_by": bound["bound_by"], "bytes_ms": bound["bytes_ms"],
             "int_floor_ms": bound["int_floor_ms"], "products_per_poly": c["products"],
             "bound_ms_u32": bound["bound_ms_u32"], "bound_by_u32": bound["bound_by_u32"],
             "pct_of_bound": 100 * bound["bound_ms"] / ms,
             "pct_of_bound_u32": 100 * bound["bound_ms_u32"] / ms, "library_ms": None,
             "library": "none: no PyTorch call computes an exact NTT mod q",
             "shape": shape, "chain_ms": ms_chain, "launches_by_path": c["by_path"]}
    if name in at_a:
        entry["at_shape_a"] = at_a[name]
    timing(name if "[" in name else f"{name} {shape}", ms, "ms",
           f" kernel ({entry['pct_of_bound']:.1f}% of its bound {bound['bound_ms']:.4f} ms, "
           f"bound by {bound['bound_by']}; integer floor {bound['int_floor_ms']:.4f} ms "
           f"({c['products']} modular products per poly); uint32-layout bound "
           f"{bound['bound_ms_u32']:.4f} ms, bound by {bound['bound_by_u32']}, "
           f"{entry['pct_of_bound_u32']:.1f}%); plain version {ms_plain:.3f} ms, radix chain "
           f"{ms_chain:.3f} ms, max |kernel - plain, chain" + (", K1" if c.get("k1") else "")
           + f"| {err} (tolerance 0: bit-exact)")
    if err != 0:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return entry


def drive_kernel_rows(dev, timing, pp, xm, by_path, lut_counts, radix_counts, radix_err,
                      noise_hybrid, at_a, prod) -> list:
    """The kernels line's rows: K1/K2 at xm ([10, 1000, 16384], the
    preimage's largest transform), K3's head there and its whole transform
    there and at K3_ROWS, each against its plain version, the radix chain and
    (at 2^14) K1, with its time, bounds, plain and chain times; the production
    ring's ntt_fwd_auto and, above 2^14, ntt_inv_auto (the radix chain); the
    L=53 rows at the shapes of `prod` (drive_production_ring's result); K1
    against K3 in turns at K1_K3_TURNS."""
    import torch

    from mxx_tpu_torch.ops import four_step, hybrid_ntt
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams

    tpp = pp.tables(dev)
    kernels = []

    def k3_tail(x, p):  # the stages t < 128 after the head, plain
        t = p.tables(dev)
        flat = x.reshape(x.shape[0], -1, p.n)
        return hybrid_ntt._radix2(flat, t.psi_rev, t.moduli, p.n // hybrid_ntt.LANE,
                                  p.n).reshape(x.shape)

    k3_rings = {pp.n: (pp, xm)}
    for args, B in K3_ROWS:
        pk = RingParams.new(*args)
        k3_rings[pk.n] = (pk, residues(pk, (B,), 7, dev))
    # the production ring's transform, routed by ntt_fwd_auto (K3 above 2^14)
    pr, xr = k3_rings[max(k3_rings)]
    reset_launches()
    auto = ntt.ntt_fwd_auto(xr, pr)
    torch.cuda.synchronize()
    auto_counts = launch_counts()
    by_path["hybrid"][f"production ring (ntt_fwd_auto, {list(xr.shape)})"] = auto_counts["hybrid"]
    tpr = pr.tables(dev)
    ok_auto = torch.equal(auto, ntt.ntt_fwd(xr, tpr.psi_rev, tpr.moduli))
    del auto
    ms_auto = cuda_ms(lambda: ntt.ntt_fwd_auto(xr, pr), 10)
    ms_auto_chain = cuda_ms(lambda: ntt.ntt_fwd(xr, tpr.psi_rev, tpr.moduli), 3)
    timing(f"ntt_fwd_auto {list(xr.shape)} (the production ring n=2^16: K3)", ms_auto, "ms",
           f"; the radix chain it replaces {ms_auto_chain:.3f} ms; launches K3 "
           f"{auto_counts['hybrid']}, K1 {auto_counts['fwd']}; equal to the chain {ok_auto} "
           f"(tolerance 0: bit-exact)")
    if not ok_auto or auto_counts["hybrid"] != 1:
        raise SystemExit("chip_smoke: ntt_fwd_auto at n=2^16 did not go through K3 exactly")
    # the inverse above 2^14 has no kernel yet: ntt_inv_auto runs the radix chain
    for n, (pk, xk) in k3_rings.items():
        if n > 16384:
            ms_inv = cuda_ms(lambda pk=pk, xk=xk: ntt.ntt_inv_auto(xk, pk), 3)
            timing(f"ntt_inv_auto {list(xk.shape)} (the radix chain)", ms_inv, "ms")

    k1_of = partial(four_step.four_step_ntt_fwd, xm, pp, 128)
    cases = [
        dict(name="four_step_ntt_fwd", source="four_step_ntt.cu",
             replaces="mxx_tpu/ops/pallas_four_step.py:135", launches=lut_counts["fwd"],
             by_path=by_path["fwd"], x=xm, run=k1_of,
             plain=partial(four_step.four_step_ntt_fwd_plain, xm, pp, 128),
             chain=partial(ntt.ntt_fwd, xm, tpp.psi_rev, tpp.moduli), plain_iters=2,
             products=ntt_products(pp.n, pp.n, True)),
        dict(name="four_step_ntt_inv", source="four_step_ntt.cu",
             replaces="mxx_tpu/ops/pallas_four_step.py:135", launches=lut_counts["inv"],
             by_path=by_path["inv"], x=xm, run=partial(four_step.four_step_ntt_inv, xm, pp, 128),
             plain=partial(four_step.four_step_ntt_inv_plain, xm, pp, 128),
             chain=partial(ntt.ntt_inv, xm, tpp.psi_inv_rev, tpp.n_inv, tpp.moduli),
             plain_iters=2, products=ntt_products(pp.n, pp.n, True)),
        # the head is held against the chain and K1 through the plain tail stages
        dict(name="ntt_fwd_head", source="radix_ntt.cu", replaces="mxx_tpu/ops/pallas_ntt.py:37",
             launches=radix_counts["head"], by_path={"radix path": radix_counts["head"]}, x=xm,
             run=partial(hybrid_ntt.ntt_fwd_head, xm, pp),
             plain=partial(hybrid_ntt.ntt_fwd_head_plain, xm, pp),
             chain=partial(ntt.ntt_fwd, xm, tpp.psi_rev, tpp.moduli), k1=k1_of,
             then=partial(k3_tail, p=pp), plain_iters=3,
             products=ntt_products(pp.n, pp.n // hybrid_ntt.LANE)),
    ]
    for n, (pk, xk) in k3_rings.items():
        tk = pk.tables(dev)
        cases.append(dict(
            name="ntt_fwd_hybrid" + ("" if n == pp.n else f" {list(xk.shape)}"),
            source="radix_ntt.cu", replaces="mxx_tpu/ops/pallas_ntt.py:37",
            launches=noise_hybrid, by_path=by_path["hybrid"], x=xk,
            run=partial(hybrid_ntt.ntt_fwd_hybrid, xk, pk),
            plain=partial(hybrid_ntt.ntt_fwd_hybrid_plain, xk, pk),
            chain=partial(ntt.ntt_fwd, xk, tk.psi_rev, tk.moduli),
            k1=k1_of if n == pp.n else None, plain_iters=3, products=ntt_products(n, n)))
    # the production depth (phase 27): K1/K2 at the anchor preimage's largest
    # transform, K3 at the direct n=2^16 preimage's, launches from that phase
    xp = residues(prod["anchor_params"], (prod["anchor_polys"],), 9, dev)
    tp = prod["anchor_params"].tables(dev)
    prod_n1 = prod["anchor_params"].n // four_step.KERNEL_N2
    for name, inverse, chain in (("four_step_ntt_fwd", False,
                                  partial(ntt.ntt_fwd, xp, tp.psi_rev, tp.moduli)),
                                 ("four_step_ntt_inv", True,
                                  partial(ntt.ntt_inv, xp, tp.psi_inv_rev, tp.n_inv, tp.moduli))):
        fn = four_step.four_step_ntt_inv if inverse else four_step.four_step_ntt_fwd
        plain = (four_step.four_step_ntt_inv_plain if inverse
                 else four_step.four_step_ntt_fwd_plain)
        d = "inv" if inverse else "fwd"
        cases.append(dict(
            name=f"{name} {list(xp.shape)}", source="four_step_ntt.cu",
            replaces="mxx_tpu/ops/pallas_four_step.py:135", launches=prod["launches"][d],
            by_path=by_path[d], x=xp, run=partial(fn, xp, prod["anchor_params"], prod_n1),
            plain=partial(plain, xp, prod["anchor_params"], prod_n1), chain=chain,
            plain_iters=1, products=ntt_products(xp.shape[-1], xp.shape[-1], True)))
    pd = prod["direct_params"]
    xd = residues(pd, (prod["direct_polys"],), 10, dev)
    td = pd.tables(dev)
    cases.append(dict(
        name=f"ntt_fwd_hybrid {list(xd.shape)}", source="radix_ntt.cu",
        replaces="mxx_tpu/ops/pallas_ntt.py:37", launches=prod["launches"]["hybrid"],
        by_path=by_path["hybrid"], x=xd, run=partial(hybrid_ntt.ntt_fwd_hybrid, xd, pd),
        plain=partial(hybrid_ntt.ntt_fwd_hybrid_plain, xd, pd),
        chain=partial(ntt.ntt_fwd, xd, td.psi_rev, td.moduli), plain_iters=1,
        products=ntt_products(pd.n, pd.n)))
    for c in cases:
        kernels.append(kernel_row(c, timing, radix_err, at_a))
        torch.cuda.empty_cache()
    del k3_rings, xr, xp, xd, cases

    # K1 against K3 in turns (K1, K3, K3, K1; median of 10 each), the measurement
    # behind ring/ntt.py's routing of 2048 <= n <= 16384
    faster = []
    for args, B in K1_K3_TURNS:
        pk = RingParams.new(*args)
        xk = xm if pk is pp else residues(pk, (B,), 8, dev)
        k1 = partial(four_step.four_step_ntt_fwd, xk, pk, pk.n // 128)
        k3 = partial(hybrid_ntt.ntt_fwd_hybrid, xk, pk)
        same = torch.equal(k1(), k3())
        turns = [("K1", cuda_ms(k1, 10)), ("K3", cuda_ms(k3, 10)), ("K3", cuda_ms(k3, 10)),
                 ("K1", cuda_ms(k1, 10))]
        ms1 = statistics.median(ms for k, ms in turns if k == "K1")
        ms3 = statistics.median(ms for k, ms in turns if k == "K3")
        faster.append(ms3 < ms1)
        timing(f"K1 against K3 in turns {list(xk.shape)}", ms3 / ms1, "K3/K1",
               f" (turns {', '.join(f'{k} {ms:.4f} ms' for k, ms in turns)}; K1 {ms1:.4f} ms, "
               f"K3 {ms3:.4f} ms; equal {same})")
        if not same:
            raise SystemExit("chip_smoke: K1 and K3 disagree")
        del xk
    routed = ntt.fwd_route("cuda", 8192)
    print(f"routing of 2048 <= n <= 16384 on the card: the turns support "
          f"{'K3' if all(faster) else 'K1'} (K3 faster at both shapes: {all(faster)}); "
          f"ring/ntt.py routes it to {routed.upper()}", flush=True)
    return kernels



# ChaCha20's draws, one launch each at a preimage call's keystream: the bench
# ring's 3,174,400 blocks (n=2^14, L=10, 50 columns: p2, p1 and the
# G-sampler's draws) and the security-100 ring's 2,621,440 (n=2^16, L=53, 2
# columns)
CHACHA_BLOCKS = (("bench ring, n=2^14 L=10 cols=50", 3_174_400),
                 ("sec100 ring, n=2^16 L=53 cols=2", 2_621_440))
# instructions per block on the path that chacha20_kernel's sm_90a SASS
# (`cuobjdump -sass` of the built library, torch 2.11 / CUDA 12.8's nvcc)
# takes for one key, counters made in the kernel, all 16 stores and one pass
# of its grid-stride loop: on the integer ALU pipe (320 LOP3 xors, 320 SHF
# rotates, 40 ISETP, 36 LEA, 16 IADD3, 8 VIADD; 64 lanes an SM), on the FMA
# pipe (ptxas issues the 320 adds as IMAD.IADD; 346 IMAD.IADD, 34 IMAD, 19
# IMAD.MOV, 19 IMAD.WIDE, 16 IMAD.X; 64 lanes), and all issued (4 schedulers
# issue 128 lanes an SM a clock); recount them when the kernel changes
CHACHA_SASS = {"alu": 740, "fma": 434, "issued": 1276}
# launches timed back to back, so that the host's enqueue of one overlaps the
# kernel before it and the time per launch is the kernel's own
CHACHA_BURST = 20


def chacha_bound(nblocks: int) -> dict:
    """The least time of `nblocks` ChaCha20 blocks: the larger of their int64
    stores (128 bytes a block over 3.35 TB/s) and the SASS's issue floor (the
    busiest of the ALU pipe, the FMA pipe and issue itself, at INT32_PER_S a
    pipe); beside it the same bound for uint32 words (64 bytes a block)."""
    bytes_ms = nblocks * 128 / HBM_BYTES_PER_S * 1e3
    per_block = max(CHACHA_SASS["alu"], CHACHA_SASS["fma"], CHACHA_SASS["issued"] / 2)
    int_ms = nblocks * per_block / INT32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, int_ms), "bound_by": "bytes" if bytes_ms >= int_ms
            else "operations", "bytes_ms": bytes_ms, "int_floor_ms": int_ms,
            "bound_ms_u32": max(bytes_ms / 2, int_ms), "bytes_ms_u32": bytes_ms / 2,
            "bound_by_u32": "bytes" if bytes_ms / 2 >= int_ms else "operations"}


def chacha_rows(dev, timing, launches: int, by_path: dict) -> list:
    """The kernels line's ChaCha20 rows: `_keystream_words` through the kernel
    of csrc/chacha20.cu against the plain twin (`_plain`) on the card, bit for
    bit, at CHACHA_BLOCKS, with the kernel's time per launch back to back and
    for one call, the twin's (CUDA events), and the kernel's bound.
    `launches` is the main path's count."""
    from mxx_tpu_torch.sampler import chacha

    key = chacha.key_from_bytes(BGG_KEY, dev)
    rows = []
    for label, nblocks in CHACHA_BLOCKS:
        nwords = 16 * nblocks
        nonces = (nblocks >> 32, 0, chacha._DOMAIN_NORMAL)
        run = partial(chacha._keystream_words, key, nwords, chacha._DOMAIN_NORMAL)
        plain = partial(chacha._plain, key[None], None, nblocks, nwords, 0, nonces)
        err = max_err(run(), plain()[0])

        def burst(run=run):
            for _ in range(CHACHA_BURST):
                run()

        ms = cuda_ms(burst, 5) / CHACHA_BURST
        ms_call = cuda_ms(run, 10)
        ms_plain = cuda_ms(plain, 2)
        bound = chacha_bound(nblocks)
        rows.append({
            "name": f"chacha20_kernel [{nblocks} blocks]", "route": "cuda",
            "source": f"mxx_tpu_torch/csrc/{chacha.SOURCE}",
            "replaces": "none: the JAX package draws ChaCha20 in jnp (mxx_tpu/sampler/chacha.py)",
            "launches": launches, "max_abs_err": err, "ms": ms, "ms_one_call": ms_call,
            "plain_ms": ms_plain,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bytes_ms": bound["bytes_ms"], "int_floor_ms": bound["int_floor_ms"],
            "sass_per_block": CHACHA_SASS, "bound_ms_u32": bound["bound_ms_u32"],
            "bound_by_u32": bound["bound_by_u32"], "pct_of_bound": 100 * bound["bound_ms"] / ms,
            "pct_of_bound_u32": 100 * bound["bound_ms_u32"] / ms, "library_ms": None,
            "library": "none: no PyTorch call computes ChaCha20", "shape": [nwords],
            "blocks": nblocks, "at": label, "chain_ms": None, "launches_by_path": by_path})
        timing(f"chacha20_kernel {nblocks} blocks ({label})", ms, "ms",
               f" kernel ({rows[-1]['pct_of_bound']:.1f}% of its bound {bound['bound_ms']:.4f} "
               f"ms, bound by {bound['bound_by']}; issue floor {bound['int_floor_ms']:.4f} ms "
               f"({CHACHA_SASS} SASS instructions per block); uint32-word bound "
               f"{bound['bound_ms_u32']:.4f} ms, bound by {bound['bound_by_u32']}); "
               f"{CHACHA_BURST} launches back to back, {ms_call:.4f} ms for one call with its "
               f"enqueue; plain twin {ms_plain:.3f} ms; max |kernel - twin| {err} (tolerance 0: "
               "bit-exact)")
        if err != 0:
            raise SystemExit("chip_smoke: the ChaCha20 kernel disagrees with its plain twin")
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mxx_tpu_torch.native import codec, writer
    from mxx_tpu_torch.ops import four_step, hybrid_ntt
    from mxx_tpu_torch.ring import ntt
    from mxx_tpu_torch.ring.params import RingParams
    from mxx_tpu_torch.sampler import FinRingDist, TrapdoorSampler, UniformSampler, chacha
    from mxx_tpu_torch.utils import tracing

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    def timing(metric, value, unit, extra=""):
        print(f"timing: {metric} = {value:.4f} {unit}{extra} [{card}]", flush=True)

    shapes = [("A", (8192, 8, 28, 14), 512), ("B", (16384, 10, 24, 12), 64)]

    # 1. build (the CUDA kernels with nvcc, the host codec and writer with g++)
    build_kernels([four_step, hybrid_ntt, chacha, codec, writer])

    # 2. K1 and K2 against the radix chain and the plain four-step
    check_four_step(dev, shapes + [("C", (16384, 10, 24, 12), 1000)])
    torch.cuda.empty_cache()

    # 3. the radix-2 kernel's path
    radix_counts, radix_err = drive_radix(dev, shapes + [
        ("D", (32768, 10, 24, 12), 8), ("E", (65536, 10, 24, 12), 4), ("F", (256, 3, 24, 5), 64)])
    torch.cuda.empty_cache()

    # 4. the main path
    pp = RingParams.new(16384, 10, 24, 12)
    ts = TrapdoorSampler(pp, 4.578, seed=2, device=dev)
    td, a = ts.trapdoor(pp, 1)
    target = UniformSampler(seed=3, device=dev).sample_uniform(pp, 1, 50, FinRingDist())
    torch.cuda.synchronize()
    reset_launches()
    x = ts.preimage(pp, td, a, target)
    torch.cuda.synchronize()
    counts = launch_counts()
    blocks = {c: tracing.counters()[c] - _launch_base.get(c, 0)
              for c in ("chacha.blocks", "chacha.kernel_blocks")}
    k = pp.modulus_digits
    shape_ok = x.shape == (k + 2, 50) and x.data.shape == (10, k + 2, 50, 16384)
    q = pp.tables(dev).moduli.view(-1, 1, 1, 1)
    range_ok = bool(((x.data >= 0) & (x.data < q)).all())
    exact = (a @ x) == target
    print(f"preimage n=16384 L=10 d=1 cols=50: x {tuple(x.data.shape)}, residues in range "
          f"{range_ok}, A x == U {exact}; launches in the call: fwd {counts['fwd']}, "
          f"inv {counts['inv']}, chacha {counts['chacha']} (keystream blocks "
          f"{blocks['chacha.kernel_blocks']} by the kernel of {blocks['chacha.blocks']})",
          flush=True)
    if not (shape_ok and range_ok and exact):
        raise SystemExit("chip_smoke: preimage check failed")
    if counts["fwd"] == 0 or counts["inv"] == 0:
        raise SystemExit("chip_smoke: the main path did not go through both kernels")
    if counts["chacha"] == 0 or blocks["chacha.kernel_blocks"] != blocks["chacha.blocks"]:
        raise SystemExit("chip_smoke: the main path's keystream did not all come from the "
                         "ChaCha20 kernel")
    del x

    # 5. BGG+ circuit evaluation
    bgg = drive_bgg(RingParams.new(8192, 8, 28, 14), dev)
    bgg_counts = bgg["launches"]
    torch.cuda.empty_cache()

    # 6. the debug LUT evaluators, batched, at the same ring
    drive_debug_lut(RingParams.new(8192, 8, 28, 14), dev)

    # 7. the LWE public-LUT chain at the realistic-scale workload
    lut_counts, lut_ms = drive_lwe_lut(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 8. Diamond witness encryption at the same ring
    we = drive_diamond_we(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 9. AKY24 functional encryption at the same ring
    fe = drive_aky24_fe(RingParams.new(8192, 8, 28, 14), dev, timing)
    torch.cuda.empty_cache()

    # 10. one nested-RNS multiplication over lifted BGG+ wires
    p = RingParams.new(8192, 8, 28, 14)
    nested_run: dict = {}
    nested_counts = drive_nested_rns_mul(p, dev, timing, nested_run)
    torch.cuda.empty_cache()

    # 11-12. the noise refresh and the masked decoder, on one trapdoor
    state = trapdoor_state(p, dev)
    refresh_counts = drive_noise_refresh(p, dev, state, timing)
    torch.cuda.empty_cache()
    decode = drive_masked_decode(p, dev, state, timing)
    del state
    torch.cuda.empty_cache()

    # 13. preimage-backed slot transfer over packed encodings
    st_counts = drive_slot_transfer(p, dev, timing)
    torch.cuda.empty_cache()

    # 14. the GGH15 chain at the realistic-scale workload, scalar and packed
    ggh15_counts = drive_ggh15_chain(p, dev, timing)
    torch.cuda.empty_cache()

    # 15. WEE25 and the commitment LUT, at a ring cut to fit T_top
    commit_counts = drive_commit_lut(p, dev, timing)
    torch.cuda.empty_cache()

    # 16. modulus switching to each limb
    drive_modulus_switch(p, dev, timing)

    # 17. Diamond iO, packed payload, debug replay, at a ring cut to fit the card
    dio = drive_diamond_io(RingParams.new(*DIO_RING), dev, timing)
    torch.cuda.empty_cache()

    # 18. the estimators: per-op costs on the card, estimates beside the
    # times of phases 8, 9, 12 and 17, and the AKY24 iO depth search
    est_counts = drive_estimators(p, RingParams.new(*DIO_RING), dev, timing, we, fe, decode, dio)
    we_counts, fe_counts, decode_counts, dio_counts = (
        x["launches"] for x in (we, fe, decode, dio))
    del we, fe, decode, dio
    torch.cuda.empty_cache()

    # 19. slice 10's matrix, poly, sampler and serde operations
    core_counts = drive_core_ops(p, dev, timing)
    torch.cuda.empty_cache()

    # 20. CKKS mul + relinearize + rescale: built, saved, loaded, evaluated
    ckks_counts = drive_ckks(p, dev, timing, nested_run)
    torch.cuda.empty_cache()

    # 21. a Montgomery multiplication over lifted BGG+ wires
    mont_counts = drive_montgomery(p, dev, timing)
    torch.cuda.empty_cache()

    # 22. the in-circuit NTT over packed slots
    nttc_counts = drive_ntt_circuit(p, dev, timing)
    torch.cuda.empty_cache()

    # 23. Diamond iO over the production LWE LUT evaluators
    lwe_dio_counts = drive_diamond_io_lwe(dev, timing)["launches"]
    torch.cuda.empty_cache()

    # 24. Diamond iO with noise everywhere, packed payload at n=256
    noise_dio_counts = drive_diamond_io_noise(dev, timing)["launches"]
    torch.cuda.empty_cache()

    # 25. parallel/: the card's mesh and logical meshes on the card
    mesh = drive_mesh(dev, timing, lut_ms)
    torch.cuda.empty_cache()

    # 26. real-mode Diamond iO at the JAX package's real-mode test config
    real_dio_counts = drive_diamond_io_real(dev, timing)["launches"]
    torch.cuda.empty_cache()

    # 27. the main path at the production depth, and the security-100 table
    prod = drive_production_ring(dev, timing)
    torch.cuda.empty_cache()

    # 28. timings
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
    # (K3 also at 2^15, 2^16 and 256, the rings ring/ntt.py sends through it)
    xm = residues(pp, (1000,), 5, dev)
    # `launches` is the count of one path: the LWE LUT chain's for K1/K2, the
    # diamond io noise phase's for K3 (the production path the routing sends
    # through it), the radix path's for K3's head; each path's own count (each
    # read around that path alone) is beside it
    paths = {"preimage": counts, "bgg circuit": bgg_counts, "lwe lut chain": lut_counts,
             "diamond we": we_counts, "aky24 fe": fe_counts, "nested rns mul": nested_counts,
             "noise refresh": refresh_counts, "masked decode": decode_counts,
             "slot transfer": st_counts, "ggh15 chain": ggh15_counts,
             "commit lut": commit_counts, "diamond io": dio_counts, "estimators": est_counts,
             "core ops": core_counts, "ckks": ckks_counts, "montgomery": mont_counts,
             "ntt circuit": nttc_counts, "diamond io lwe": lwe_dio_counts,
             "diamond io noise": noise_dio_counts, "diamond io real": real_dio_counts,
             "mesh (1x4 sharded preimage)": mesh["preimage"],
             "mesh (lwe lut chain over 1x4)": mesh["lwe"],
             **{f"production ring n={n}": c for n, c in prod["per_ring"].items()}}
    by_path = {d: {name: c[d] for name, c in paths.items()} for d in ("fwd", "inv", "hybrid")}
    by_path["hybrid"]["radix path"] = radix_counts["hybrid"]
    by_path["chacha"] = {name: c.get("chacha") for name, c in paths.items()}

    kernels = drive_kernel_rows(dev, timing, pp, xm, by_path, lut_counts, radix_counts,
                                radix_err, noise_dio_counts["hybrid"], at_a, prod)
    del xm
    torch.cuda.empty_cache()
    kernels += chacha_rows(dev, timing, counts["chacha"], by_path["chacha"])
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
