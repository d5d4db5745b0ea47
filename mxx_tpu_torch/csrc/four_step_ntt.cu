// Four-step negacyclic NTT over CRT limbs, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of mxx_tpu/ops/pallas_four_step.py:
//   _make_kernel(inverse=False), run by four_step_ntt_fwd_fused, and
//   _make_kernel(inverse=True),  run by four_step_ntt_inv_fused.
// It computes what they compute, bit for bit: with n = n1 * n2 and a poly
// viewed as the row-major matrix x[n2][n1],
//   forward  X = ((W2 . x) o T) . W1           (EVAL, bit-reversed order)
//   inverse  x = W2^-1 . ((X . W1^-1) o T^-1)
// where W2 [n2][n2], T [n2][n1] and W1 [n1][n1] are the tables of
// mxx_tpu/ops/four_step_ntt.py:_tables. The TPU kernel takes both products
// as dense matrix products on its matrix unit (int8 digit planes); a dense
// product costs n (n1 + n2) multiply-adds per poly where butterflies cost
// (n/2) log2(n), and Hopper's 32-bit multiplies are native, so here each
// product is a transform of butterflies:
//   W2 . (column)  the merged-twist negacyclic NTT of length n2 with root
//                  psi^n1 (Cooley-Tukey, natural in, bit-reversed out),
//   o T            one Shoup product per element,
//   (row) . W1     the cyclic NTT of length n1 with root psi^(2 n2)
//                  (Cooley-Tukey, natural in, bit-reversed out; the block i
//                  of every stage takes the twiddle w^bitrev(i)).
// The inverse runs Gentleman-Sande butterflies with the inverse twiddles in
// the reverse order, rows first; n^-1 is folded into the T^-1 table, so the
// scaling costs nothing. Every step is exact mod q and keeps each residue in
// [0, q), so the result equals the dense products bit for bit.
//
// Layout: one thread block of n/16 threads (at most 512) transforms one
// (limb, poly) pair. A pass loads, for each thread, the 2^k elements that k
// consecutive stages mix (a column segment of 16 or 8, a row segment) into
// registers, runs those k stages there, and stores them back: a column takes
// two passes (4 + 3 stages), a row one or two, and a __syncthreads separates
// the passes. Between passes the poly stays in shared memory as uint32, in
// rows of n1 + 1 words so that column and row walks are free of bank
// conflicts. Device memory is touched where a warp's accesses are
// contiguous: the column pass next to the input or the output reads or
// writes int64 on consecutive columns, and the row end of the transform is
// staged through shared memory (16 bytes a thread, 512 bytes a warp). The
// twist multiplies in the column pass next to the rows, where a warp reads
// consecutive table entries. (Writing the rows straight from registers,
// with a warp's lanes 8 n1 bytes apart, ran slower on an H100, and so did
// 256 threads at n = 16384 and 512 at n = 2048.)
// All modular products are Shoup products with per-twiddle quotients
// wq = floor(w 2^32 / q) built on the host (one high multiply, two low
// multiplies, one min): no 64-bit arithmetic and no division in the kernel.
//
// Tables per limb, each entry (w, wq) as a uint2: col [n2] (psi^n1 to the
// bit-reversed exponents, forward, or their inverses), row [n1/2]
// (w^bitrev(i), or inverses) and twist [n2][n1] (T, or n^-1 T^-1).
//
// Bounds on this card: q < 2^31 (residues and sums below 2q fit in 32
// bits); n2 = 128 and 16 <= n1 <= 128, powers of two (the plan of
// mxx_tpu/ring/ntt.py for 2048 <= n <= 16384); shared memory 4 (n + 128)
// bytes, 66 KB at n = 16384, so three blocks fit on an SM.
// What bounds it: device memory sees the int64 input and output once (16
// bytes per residue, 0.78 ms at [10, 1000, 16384] on an H100 at 3.35 TB/s);
// the integer work is (n/2) log2(n) butterflies of about eleven 32-bit
// instructions plus n twist products, of the same order on this card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogN2 = 7;
constexpr int kN2 = 1 << kLogN2;
constexpr int kMaxThreads = 512;

// threads of a block: n/16, at most kMaxThreads (measured best on an H100
// at n = 2048, 8192 and 16384)
__host__ __device__ constexpr int block_threads(int log_n1) {
  return (kN2 << log_n1) / 16 < kMaxThreads ? (kN2 << log_n1) / 16 : kMaxThreads;
}

// b * w mod q for b, w < q < 2^31 and t = (w, floor(w 2^32 / q))
__device__ __forceinline__ uint32_t mul_shoup(uint32_t b, uint2 t, uint32_t q) {
  const uint32_t hi = __umulhi(b, t.y);
  const uint32_t r = b * t.x - hi * q;  // exact mod 2^32, in [0, 2q)
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

// Where a pass reads its elements from and writes them to.
enum Io { kShared, kGlobal };

// One pass over every line of the poly: the stages [kJ0, kJ0 + kLog) of the
// length-2^kLogLen transform of each line, with each thread holding in
// registers the 2^kLog elements that those stages mix. Lines are the n1
// columns (kCols) or the n2 rows. Elements come from shared memory (rows of
// n1 + 1 words) or from the int64 input, and go to shared memory or the
// int64 output. Forward passes run Cooley-Tukey stages, inverse passes
// Gentleman-Sande stages in the reverse order. The block i of stage j takes
// tw[2^j + i] for the negacyclic column transform and tw[i] for the cyclic
// row transform. With kTwist each element is multiplied by its
// twist[row][col]: after the stages of a forward pass, before those of an
// inverse one. Threads take the lines in turn, so that a warp's accesses to
// a column pass's elements are consecutive and those of a row pass fall on
// distinct banks.
template <int kLogN1, int kLog, int kJ0, bool kCols, bool kInverse, bool kTwist, Io kIn, Io kOut>
__device__ __forceinline__ void pass(uint32_t* s, const int64_t* __restrict__ x,
                                     int64_t* __restrict__ out, const uint2* __restrict__ tw,
                                     const uint2* __restrict__ twist, uint32_t q) {
  constexpr int kPitch = (1 << kLogN1) + 1;
  constexpr int kLogLen = kCols ? kLogN2 : kLogN1;
  constexpr int kLogLines = kCols ? kLogN1 : kLogN2;
  constexpr int kR = 1 << kLog;
  constexpr int kLogBlock = kLogLen - kJ0;  // block size at stage kJ0
  constexpr int kLogStride = kLogBlock - kLog;  // distance of a group's elements
  constexpr int kTasks = 1 << (kLogLines + kLogLen - kLog);
  static_assert(kLogStride >= 0, "a pass mixes at most one block of its first stage");
  static_assert(kCols || (kIn == kShared && kOut == kShared),
                "only a column pass touches device memory");
  for (int task = threadIdx.x; task < kTasks; task += block_threads(kLogN1)) {
    const int line = task & ((1 << kLogLines) - 1);
    const int group = task >> kLogLines;
    const int g = group >> kLogStride;  // block of stage kJ0
    const int p0 = (g << kLogBlock) + (group & ((1 << kLogStride) - 1));
    // element k: line position p0 + k 2^kLogStride, at row r and column c
    auto flat = [&](int k) {  // r n1 + c
      const int p = p0 + (k << kLogStride);
      return kCols ? (p << kLogN1) + line : (line << kLogN1) + p;
    };
    auto shared = [&](int k) {  // r (n1 + 1) + c
      const int p = p0 + (k << kLogStride);
      return kCols ? p * kPitch + line : line * kPitch + p;
    };
    uint32_t v[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      v[k] = kIn == kGlobal
                 ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(x + flat(k))))
                 : s[shared(k)];
    }
    if constexpr (kTwist && kInverse) {
#pragma unroll
      for (int k = 0; k < kR; ++k) v[k] = mul_shoup(v[k], __ldg(twist + flat(k)), q);
    }
    // every loop has a constant trip count and the guards fold once they are
    // unrolled, so that v stays in registers
#pragma unroll
    for (int step = 0; step < kLog; ++step) {
      const int l = kInverse ? kLog - 1 - step : step;  // stage kJ0 + l
      const int half = kR >> (l + 1);  // pair distance in registers
#pragma unroll
      for (int kb = 0; kb < kR / 2; ++kb) {
        if (kb < (1 << l)) {  // block of the group at this stage
          const int i = (g << l) + kb;  // block index at stage kJ0 + l
          const uint2 w = __ldg(tw + (kCols ? (1 << (kJ0 + l)) + i : i));
#pragma unroll
          for (int kk = 0; kk < kR / 2; ++kk) {
            if (kk < half) {
              const int a = kb * 2 * half + kk;
              const uint32_t x0 = v[a];
              const uint32_t x1 = v[a + half];
              if (kInverse) {
                v[a] = add_mod(x0, x1, q);
                v[a + half] = mul_shoup(sub_mod(x0, x1, q), w, q);
              } else {
                const uint32_t wb = mul_shoup(x1, w, q);
                v[a] = add_mod(x0, wb, q);
                v[a + half] = sub_mod(x0, wb, q);
              }
            }
          }
        }
      }
    }
    if constexpr (kTwist && !kInverse) {
#pragma unroll
      for (int k = 0; k < kR; ++k) v[k] = mul_shoup(v[k], __ldg(twist + flat(k)), q);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (kOut == kGlobal) {
        out[flat(k)] = v[k];
      } else {
        s[shared(k)] = v[k];
      }
    }
  }
}

// x (int64, n1 words a row) -> s (uint32, n1 + 1 words a row), 16 bytes a thread
template <int kLogN1>
__device__ __forceinline__ void stage_in(uint32_t* s, const int64_t* __restrict__ x) {
  constexpr int kN1 = 1 << kLogN1;
  constexpr int kN = kN1 * kN2;
  const auto* x2 = reinterpret_cast<const longlong2*>(x);
#pragma unroll 4
  for (int e = threadIdx.x; e < kN / 2; e += block_threads(kLogN1)) {
    const longlong2 v = __ldg(x2 + e);
    const int i = (e >> (kLogN1 - 1)) * (kN1 + 1) + 2 * (e & (kN1 / 2 - 1));
    s[i] = static_cast<uint32_t>(v.x);
    s[i + 1] = static_cast<uint32_t>(v.y);
  }
}

// s -> out, the inverse of stage_in
template <int kLogN1>
__device__ __forceinline__ void stage_out(const uint32_t* s, int64_t* __restrict__ out) {
  constexpr int kN1 = 1 << kLogN1;
  constexpr int kN = kN1 * kN2;
  auto* o2 = reinterpret_cast<longlong2*>(out);
#pragma unroll 4
  for (int e = threadIdx.x; e < kN / 2; e += block_threads(kLogN1)) {
    const int i = (e >> (kLogN1 - 1)) * (kN1 + 1) + 2 * (e & (kN1 / 2 - 1));
    o2[e] = make_longlong2(s[i], s[i + 1]);
  }
}

// grid (B, L): block (b, l) transforms x[l][b][:] into out[l][b][:]. The
// first pass reads the input and the last one writes the output; shared
// memory holds the poly between passes.
template <int kLogN1, bool kInverse>
__global__ void __launch_bounds__(kMaxThreads)
four_step_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                 const uint2* __restrict__ col_tw, const uint2* __restrict__ twist,
                 const uint2* __restrict__ row_tw, const uint32_t* __restrict__ moduli, int B) {
  constexpr int kN1 = 1 << kLogN1;
  constexpr int kN = kN1 * kN2;
  // column passes 4 + 3 stages; row passes up to 4 stages, or k - 3 and 3
  constexpr int kRowA = kLogN1 <= 4 ? kLogN1 : kLogN1 - 3;
  constexpr int kRowB = kLogN1 - kRowA;
  extern __shared__ __align__(16) uint32_t s[];
  const int l = blockIdx.y;
  const int64_t poly = static_cast<int64_t>(l) * B + blockIdx.x;
  x += poly * kN;
  out += poly * kN;
  const uint32_t q = moduli[l];
  col_tw += static_cast<int64_t>(l) * kN2;
  twist += static_cast<int64_t>(l) * kN;
  row_tw += static_cast<int64_t>(l) * (kN1 / 2);

  if (!kInverse) {
    pass<kLogN1, 4, 0, true, false, false, kGlobal, kShared>(s, x, out, col_tw, twist, q);
    __syncthreads();
    pass<kLogN1, 3, 4, true, false, true, kShared, kShared>(s, x, out, col_tw, twist, q);
    __syncthreads();
    pass<kLogN1, kRowA, 0, false, false, false, kShared, kShared>(s, x, out, row_tw, twist, q);
    if constexpr (kRowB > 0) {
      __syncthreads();
      pass<kLogN1, kRowB, kRowA, false, false, false, kShared, kShared>(s, x, out, row_tw,
                                                                         twist, q);
    }
    __syncthreads();
    stage_out<kLogN1>(s, out);
  } else {
    stage_in<kLogN1>(s, x);
    __syncthreads();
    if constexpr (kRowB > 0) {
      pass<kLogN1, kRowB, kRowA, false, true, false, kShared, kShared>(s, x, out, row_tw, twist,
                                                                        q);
      __syncthreads();
    }
    pass<kLogN1, kRowA, 0, false, true, false, kShared, kShared>(s, x, out, row_tw, twist, q);
    __syncthreads();
    pass<kLogN1, 3, 4, true, true, true, kShared, kShared>(s, x, out, col_tw, twist, q);
    __syncthreads();
    pass<kLogN1, 4, 0, true, true, false, kShared, kGlobal>(s, x, out, col_tw, twist, q);
  }
}

template <int kLogN1, bool kInverse>
cudaError_t launch(const int64_t* x, int64_t* out, const uint2* col_tw, const uint2* twist,
                   const uint2* row_tw, const uint32_t* moduli, int L, int B,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kN2) * ((1 << kLogN1) + 1) * sizeof(uint32_t);
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t err = cudaFuncSetAttribute(four_step_kernel<kLogN1, kInverse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(L));
  four_step_kernel<kLogN1, kInverse><<<grid, block_threads(kLogN1), smem, stream>>>(
      x, out, col_tw, twist, row_tw, moduli, B);
  return cudaGetLastError();
}

template <bool kInverse>
cudaError_t dispatch(const int64_t* x, int64_t* out, const uint2* col_tw, const uint2* twist,
                     const uint2* row_tw, const uint32_t* moduli, int L, int B, int n1,
                     cudaStream_t stream) {
  switch (n1) {
    case 16: return launch<4, kInverse>(x, out, col_tw, twist, row_tw, moduli, L, B, stream);
    case 32: return launch<5, kInverse>(x, out, col_tw, twist, row_tw, moduli, L, B, stream);
    case 64: return launch<6, kInverse>(x, out, col_tw, twist, row_tw, moduli, L, B, stream);
    case 128: return launch<7, kInverse>(x, out, col_tw, twist, row_tw, moduli, L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. x and out are int64 [L][B][n] (16-byte aligned),
// n = n1 * n2; col [L][n2], twist [L][n2][n1] and row [L][n1/2] are pairs
// (w, floor(w 2^32 / q)) of uint32, moduli uint32 [L]. The forward transform
// takes the forward tables, the inverse the inverse ones (twist n^-1 T^-1).
// Returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue for
// n2 != 128 or n1 outside 16..128); the caller checks shapes and bounds
// before the call.
extern "C" int mxx_four_step_ntt(const void* x, void* out, const void* col, const void* twist,
                                 const void* row, const void* moduli, int L, int B, int n1,
                                 int n2, int inverse, void* stream) {
  if (n2 != kN2) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  const auto* ci = static_cast<const uint2*>(col);
  const auto* ti = static_cast<const uint2*>(twist);
  const auto* ri = static_cast<const uint2*>(row);
  const auto* qi = static_cast<const uint32_t*>(moduli);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = inverse ? dispatch<true>(xi, oi, ci, ti, ri, qi, L, B, n1, s)
                                  : dispatch<false>(xi, oi, ci, ti, ri, qi, L, B, n1, s);
  return static_cast<int>(err);
}
