// Radix-2 merged-twist forward negacyclic NTT over CRT limbs, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxx_tpu/ops/pallas_ntt.py: _fwd_head_kernel,
// launched by _head_call for ntt_fwd_head_pallas and ntt_fwd_hybrid. It
// computes what that kernel computes, bit for bit: the Cooley-Tukey stages
// of the merged-twist forward transform (natural coefficients in, bit-reversed
// evaluations out), stage j (m = 2^j blocks, pair distance t = n / 2m) taking
// each block i to
//   a = x[2 i t + k], b = x[2 i t + t + k], w = psi_rev[m + i]   (k < t)
//   (a, b) -> (a + w b, a - w b) mod q.
// The TPU version stops at t = 128 (Mosaic cannot reshape below the 128-wide
// lane dimension) and leaves the rest to jnp. The kernel runs the stages with
// t >= t_min: t_min = 128 is the TPU kernel (ntt_fwd_head), t_min = 1 the
// whole transform in one launch (ntt_fwd_hybrid, which ring/ntt.py's
// ntt_fwd_auto routes forward transforms to).
//
// Bounds: q < 2^31; 256 <= n <= 65536, a power of two; t_min a power of two,
// at most n / cluster. What bounds it on this card: device memory, for the
// int64 layout (16 bytes per coefficient read and written once: 0.78 ms at
// [10, 1000, 16384] on an H100 at 3.35 TB/s); for the TPU kernel's uint32
// layout (8 bytes) the whole transform at n = 2^16 is bound by integer
// operations (n/2 log2 n modular products per poly). The design:
//
// - One block of 512 threads per SM, persistent. A block iteration
//   transforms 16384 coefficients: 16384 / n polys of n <= 16384, or its part
//   of one poly of 2^15 or 2^16, which a cluster of 2 or 4 blocks shares.
//   The part stays in shared memory as uint32 (64 KB) through every stage.
// - Loads overlapped with compute. As soon as a block has copied an
//   iteration's int64 input out of its 128 KB staging buffer, one thread
//   asks for the next iteration's with asynchronous bulk copies
//   (cp.async.bulk, completing on an mbarrier), which land while this
//   iteration's stages run and its output is written. The copies take no
//   registers; holding the next iteration in registers instead needed 64 a
//   thread, so 256 threads, and ran slower on an H100.
// - Register passes. A pass runs k <= 5 consecutive stages: each thread holds
//   the 2^k coefficients those stages mix in registers, and shared memory is
//   touched only between passes (3 passes and 3 barriers for the 14 stages at
//   n = 2^14, instead of one per stage). The output goes out from shared
//   memory, 16 bytes a thread on consecutive addresses, at the end of each
//   iteration (staging it as int64 for asynchronous bulk copies, so that they
//   drain during the next iteration, ran slower on an H100).
// - Twiddles loaded once per limb where they fit. The block copies the
//   leading passes' twiddles of its limb ((w, floor(w 2^32 / q)) pairs; the
//   whole table for n <= 4096) into shared memory when its iterations move
//   to the next limb; a later pass reads its own through the caches. The
//   host lays each pass's twiddles out as [stage][block of the stage within
//   a group][group], so that a warp's lanes read consecutive entries or one
//   broadcast entry.
// - Shoup products with per-twiddle quotients built on the host (wq =
//   floor(w 2^32 / q)): one high and two low 32-bit multiplies and a min, no
//   64-bit arithmetic. Every stage keeps residues in [0, q). Lazy (Harvey)
//   butterflies, residues in [0, 4q) between stages, ran no faster on an
//   H100: the kernel waits on memory, not on its integer instructions.
// - No bank conflicts. A row of shared memory has one pad word per 32 (word
//   p at p + p / 32); with at most 5 stages per pass and the last pass taking
//   5 stages when there are 10 or more, every pass's accesses fall on 32
//   distinct banks (ops/hybrid_ntt.py checks the plan).
// - n = 2^15 and 2^16 over a cluster of 2 or 4 blocks, each holding a
//   contiguous part. The first log2(cluster) stages pair coefficients of two
//   parts: for each, the two blocks of a pair split the butterflies between
//   them and read and write each other's part through distributed shared
//   memory (each thread's 16 pairs loaded at once), between cluster barriers.
//   From then on each part is independent.
//
// ops/hybrid_ntt.py makes the launch plan (stages per pass, polys per block
// iteration, cluster size, shared-memory bytes, the twiddles held in shared
// memory) and the twiddle table and passes them here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCoeffs = 1 << 14;  // coefficients of a block iteration
constexpr int kPer = kCoeffs / kThreads;
constexpr int kX = kCoeffs / 2 / kThreads;  // pairs a thread takes in a cluster stage
constexpr int kMaxK = 5;
constexpr int kMaxPasses = 3;
constexpr int kSlots = 2;  // twiddle table entries for the cluster's stages

struct Plan {
  int log_n;               // ring degree n = 2^log_n
  int log_local;           // log2 of a block's part of a poly (n / cluster)
  int polys;               // polys per block iteration
  int L;                   // limbs
  int B;                   // polys per limb
  int npasses;
  int k[kMaxPasses];       // stages per pass
  int j0[kMaxPasses];      // first stage of each pass, within a block's part
  int tw_off[kMaxPasses];  // where each pass's twiddles start in a rank's table
  int tw_entries;          // entries of a rank's table
  int tw_shared;           // leading entries of it held in shared memory
};

// shared-memory word of position p of a row: one pad word per 32
__device__ __forceinline__ int sidx(int p) { return p + (p >> 5); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// bytes (a multiple of 16) from global src to shared dst, in chunks, all
// reported to bar, which completes its phase when they have all arrived
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  constexpr uint32_t kChunk = 16384;
  for (uint32_t o = 0; o < bytes; o += kChunk) {
    const uint32_t n = bytes - o < kChunk ? bytes - o : kChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(static_cast<char*>(dst) + o)), "l"(static_cast<const char*>(src) + o),
           "r"(n), "r"(smem_u32(bar)) : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tWAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}"
      :: "r"(smem_u32(bar)), "r"(phase) : "memory");
}

// (x, y) -> (x + w y, x - w y) mod q for x, y < q < 2^31, with
// (w, floor(w 2^32 / q)) in w
__device__ __forceinline__ void butterfly(uint32_t& x, uint32_t& y, uint2 w, uint32_t q) {
  uint32_t t = y * w.x - __umulhi(y, w.y) * q;  // Shoup: exact mod 2^32, in [0, 2q)
  t = min(t, t - q);
  const uint32_t s = x + t;
  const uint32_t d = x - t;
  x = min(s, s - q);
  y = min(d, d + q);
}

// One pass over shared memory: stages j0 .. j0 + K - 1 of the block's part
// (2^log_local words a poly, `polys` polys of it a row each). A group is the
// 2^K positions that those stages mix, p0 + r 2^log_stride; group `task` of
// poly slot ps goes to thread task mod kThreads, so that a warp's lanes take
// consecutive groups. tw holds the pass's twiddles: stage l's block kb of
// group-block g at ((2^l - 1 + kb) 2^j0 + g).
template <int K>
__device__ __forceinline__ void pass(uint32_t* s, const uint2* tw, const Plan& pl, int j0,
                                     uint32_t q) {
  constexpr int kR = 1 << K;
  const int log_local = pl.log_local;
  const int log_block = log_local - j0;  // block size at stage j0
  const int log_stride = log_block - K;  // distance of a group's positions
  const int log_groups = log_local - K;  // groups per poly
  const int pitch = (1 << log_local) + (1 << (log_local - 5));
  const int tasks = pl.polys << log_groups;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int ps = task >> log_groups;
    const int group = task & ((1 << log_groups) - 1);
    const int g = group >> log_stride;
    const int p0 = (g << log_block) + (group & ((1 << log_stride) - 1));
    uint32_t* row = s + ps * pitch;
    uint32_t v[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = row[sidx(p0 + (r << log_stride))];
    // constant trip counts and guards that fold once unrolled, so that v
    // stays in registers
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const int half = kR >> (l + 1);  // pair distance in registers
#pragma unroll
      for (int kb = 0; kb < kR / 2; ++kb) {
        if (kb < (1 << l)) {
          const uint2 w = tw[(((1 << l) - 1 + kb) << j0) + g];
#pragma unroll
          for (int kk = 0; kk < kR / 2; ++kk) {
            if (kk < half) {
              const int a = kb * 2 * half + kk;
              butterfly(v[a], v[a + half], w, q);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) row[sidx(p0 + (r << log_stride))] = v[r];
  }
}

__device__ __forceinline__ void run_pass(int k, uint32_t* s, const uint2* tw, const Plan& pl,
                                         int j0, uint32_t q) {
  switch (k) {
    case 1: pass<1>(s, tw, pl, j0, q); break;
    case 2: pass<2>(s, tw, pl, j0, q); break;
    case 3: pass<3>(s, tw, pl, j0, q); break;
    case 4: pass<4>(s, tw, pl, j0, q); break;
    default: pass<kMaxK>(s, tw, pl, j0, q); break;
  }
}

// 1-D grid of `units` clusters of kCluster blocks (block rank r holding part
// r of each poly). Block iterations are numbered limb-major, f = l iters + i,
// and unit u takes f = u, u + units, ...
template <int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
radix_ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                     const uint2* __restrict__ tw_all, const uint32_t* __restrict__ moduli,
                     const __grid_constant__ Plan pl) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t bar;
  int rank = 0;
  if constexpr (kCluster > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int unit = blockIdx.x / kCluster;
  const int units = gridDim.x / kCluster;
  const int log_local = pl.log_local;
  const int pitch = (1 << log_local) + (1 << (log_local - 5));
  uint32_t* s = smem;
  int64_t* stage = reinterpret_cast<int64_t*>(smem + pl.polys * pitch);
  uint2* s_tw = reinterpret_cast<uint2*>(stage + kCoeffs);
  const int iters = (pl.B + pl.polys - 1) / pl.polys;
  const int total = pl.L * iters;
  // element e = threadIdx.x + r kThreads of an iteration: poly slot
  // e >> log_local, position e mod 2^log_local; it sits 2e words past the
  // start of the iteration's part in x (rows are contiguous, and a cluster's
  // iteration is one poly)
  auto first = [&](int f) {  // offset of iteration f's part in x and out
    const int l = f / iters;
    return ((static_cast<int64_t>(l) * pl.B + (f - l * iters) * pl.polys) << pl.log_n) +
           (static_cast<int64_t>(rank) << log_local);
  };
  auto valid_polys = [&](int f) { return min(pl.polys, pl.B - (f % iters) * pl.polys); };
  auto fetch = [&](int f) {  // thread 0: iteration f's part into the staging buffer
    bulk_load(stage, x + first(f), static_cast<uint32_t>(valid_polys(f)) << (log_local + 3),
              &bar);
  };
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();

  int limb = -1;
  uint32_t phase = 0;
  if (threadIdx.x == 0 && unit < total) fetch(unit);
  for (int f = unit; f < total; f += units) {
    const int l = f / iters;
    const uint32_t q = moduli[l];
    const uint2* gtw = tw_all + (static_cast<int64_t>(l) * kCluster + rank) * pl.tw_entries;
    __syncthreads();  // shared memory is free
    if (l != limb) {  // the leading entries of this limb's twiddles (a rank's table)
      for (int i = threadIdx.x; i < pl.tw_shared; i += kThreads) s_tw[i] = gtw[i];
      limb = l;
    }
    mbar_wait(&bar, phase);
    phase ^= 1;
    const int valid = valid_polys(f);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = threadIdx.x + r * kThreads;
      s[(e >> log_local) * pitch + sidx(e & ((1 << log_local) - 1))] =
          (e >> log_local) < valid ? static_cast<uint32_t>(stage[e]) : 0u;
    }
    __syncthreads();  // the staging buffer is free
    if (threadIdx.x == 0 && f + units < total) fetch(f + units);  // lands during the stages
    if constexpr (kCluster > 1) {
      // the stages that pair two parts: stage c pairs part r with part
      // r + span (span = kCluster / 2^(c+1)); the pair's two blocks split
      // its butterflies, the lower rank taking the first half of the part
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
#pragma unroll
      for (int c = 0; (1 << c) < kCluster; ++c) {
        const int span = kCluster >> (c + 1);
        const int lo = rank & ~span;
        uint32_t* sa = lo == rank ? s : cluster.map_shared_rank(s, lo);
        uint32_t* sb = lo == rank ? cluster.map_shared_rank(s, lo + span) : s;
        const uint2 w = s_tw[c];
        // this block's half of the pairs, kX a thread, all loads in flight at once
        const int i0 = sidx(((rank & span) ? kCoeffs / 2 : 0) + threadIdx.x);
        uint32_t a[kX], b[kX];
#pragma unroll
        for (int r = 0; r < kX; ++r) {
          a[r] = sa[i0 + r * sidx(kThreads)];
          b[r] = sb[i0 + r * sidx(kThreads)];
        }
#pragma unroll
        for (int r = 0; r < kX; ++r) {
          butterfly(a[r], b[r], w, q);
          sa[i0 + r * sidx(kThreads)] = a[r];
          sb[i0 + r * sidx(kThreads)] = b[r];
        }
        cluster.sync();
      }
    }
    for (int p = 0; p < pl.npasses; ++p) {
      if (p > 0) __syncthreads();
      const int end = pl.tw_off[p] + (((1 << pl.k[p]) - 1) << pl.j0[p]);
      run_pass(pl.k[p], s, (end <= pl.tw_shared ? s_tw : gtw) + pl.tw_off[p], pl, pl.j0[p], q);
    }
    __syncthreads();
    // shared memory -> out, 16 bytes a thread
    auto* o2 = reinterpret_cast<longlong2*>(out + first(f));
    const int pairs = valid_polys(f) << (log_local - 1);
#pragma unroll 4
    for (int e = threadIdx.x; e < pairs; e += kThreads) {
      const int i = (e >> (log_local - 1)) * pitch + sidx(2 * (e & ((1 << (log_local - 1)) - 1)));
      o2[e] = make_longlong2(s[i], s[i + 1]);
    }
  }
}

template <int kCluster>
cudaError_t launch(const int64_t* x, int64_t* out, const uint2* tw, const uint32_t* moduli,
                   const Plan& pl, int units, int smem, cudaStream_t stream) {
  auto kernel = radix_ntt_fwd_kernel<kCluster>;
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;
  if constexpr (kCluster > 1) {
    // one wave: no more clusters than the card holds at once
    int fit = 0;
    cfg.gridDim = dim3(static_cast<unsigned>(units * kCluster));
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit > 0 && fit < units) units = fit;
  }
  cfg.gridDim = dim3(static_cast<unsigned>(units * kCluster));
  err = cudaLaunchKernelEx(&cfg, kernel, x, out, tw, moduli, pl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. x and out are int64 [L][B][n] (16-byte aligned,
// n = 2^log_n); tw is uint2 [L][cluster][tw_entries], each rank's twiddles
// with their Shoup quotients in the order of ops/hybrid_ntt.py's
// twiddle_table (entries 0 and 1: the cluster's stages; the first tw_shared
// entries, whole passes, are copied into shared memory); moduli uint32 [L].
// Runs the stages with pair distance t >= t_min: log2(cluster) across the
// parts of a poly, then passes of k_p stages, k_p packed 4 bits each in
// `passes` (pass p in bits 4p..4p+3); a block iteration takes `polys` polys
// of n <= 16384 or one 16384-coefficient part; `units` clusters (at most
// one per SM). Returns the launch's cudaError_t (0
// on success; cudaErrorInvalidValue for a plan that does not add up); the
// caller checks shapes and bounds before the call.
extern "C" int mxx_radix_ntt_fwd(const void* x, void* out, const void* tw, const void* moduli,
                                 int L, int B, int log_n, int t_min, int cluster, int polys,
                                 int passes, int tw_entries, int tw_shared, int smem, int units,
                                 void* stream) {
  const int log_c = cluster == 4 ? 2 : cluster == 2 ? 1 : 0;
  Plan pl = {};
  pl.log_n = log_n;
  pl.log_local = log_n - log_c;
  pl.polys = polys;
  pl.L = L;
  pl.B = B;
  int stages = 0;
  int off = kSlots;
  for (int p = 0; p < kMaxPasses && (passes >> (4 * p)) & 15; ++p) {
    pl.k[p] = (passes >> (4 * p)) & 15;
    pl.j0[p] = stages;
    pl.tw_off[p] = off;
    if (pl.k[p] > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    off += ((1 << pl.k[p]) - 1) << stages;
    stages += pl.k[p];
    pl.npasses = p + 1;
  }
  pl.tw_entries = tw_entries;
  pl.tw_shared = tw_shared;
  if (tw_shared > tw_entries || (1 << log_c) != cluster || t_min < 1 || (t_min & (t_min - 1)) ||
      (1 << log_n) != t_min << (stages + log_c) || off != tw_entries || pl.log_local < 8 ||
      polys << pl.log_local != kCoeffs || (cluster > 1 && pl.log_local != 14) || units < 1 ||
      (cluster == 1 && pl.npasses == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  const auto* ti = static_cast<const uint2*>(tw);
  const auto* qi = static_cast<const uint32_t*>(moduli);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cluster) {
    case 4: err = launch<4>(xi, oi, ti, qi, pl, units, smem, s); break;
    case 2: err = launch<2>(xi, oi, ti, qi, pl, units, smem, s); break;
    default: err = launch<1>(xi, oi, ti, qi, pl, units, smem, s);
  }
  return static_cast<int>(err);
}
