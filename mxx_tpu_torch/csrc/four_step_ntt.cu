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
// mxx_tpu/ops/four_step_ntt.py:_tables (standard form here), "." a matrix
// product mod q and "o" an elementwise product mod q. The n^-1 scaling of
// the inverse is implied by the exact inverse tables.
//
// What the TPU kernel does for its matrix unit (int8 digit planes, the
// 96-bit word packing, p_polys blocking) is not carried over. Here one
// thread block transforms one (limb, poly) pair:
//   1. stage the poly in shared memory as uint32 (4n bytes),
//   2. the first product (and the twiddle) into a second shared buffer,
//   3. the second product straight to the int64 output in device memory.
// Each output is a dot product of length n2 or n1 of 32-bit residues,
// accumulated exactly as a 64-bit sum plus a carry count and reduced once.
//
// Bounds on this card:
//   q < 2^31 (residues and table entries fit in 31 bits, so a product is
//   below 2^62 and at most 2^8 products give a carry count below 2^7);
//   n = n1 * n2 <= 16384: the two buffers take 8n bytes of shared memory,
//   128 KB at n = 16384, within the 227 KB a block can have;
//   4 <= n1 <= 256 and 8 <= n2 <= 256, powers of two (n1 <= threads per
//   block; vector loads of 4 table or buffer entries).
// What bounds it: integer multiply-adds, n * (n1 + n2) per poly, plus the
// 64-bit remainders of the reductions; device memory sees the int64 input
// and output once. At n = 16384 one block fills 128 KB, so one block runs per
// SM; the design keeps the tables in device memory (read through L1/L2) and
// reuses each shared-memory load over kRows outputs held in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output rows per thread per pass

__device__ __forceinline__ void mac(uint64_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  lo += p;
  hi += (lo < p);
}

// (hi * 2^64 + lo) mod q, with r64 = 2^64 mod q
__device__ __forceinline__ uint32_t reduce(uint64_t lo, uint32_t hi, uint32_t q, uint64_t r64) {
  return static_cast<uint32_t>((lo % q + static_cast<uint64_t>(hi) * r64) % q);
}

__device__ __forceinline__ void store(uint32_t* dst_s, int64_t* dst_g, int idx, uint32_t v) {
  if (dst_g != nullptr) {
    dst_g[idx] = v;
  } else {
    dst_s[idx] = v;
  }
}

// dst[r][c] = (sum_k wl[r][k] * src[k][c]) * tw[r][c]   (r, k < n2; c < n1)
// tw may be null (no twiddle); dst is dst_g (device memory) if not null,
// else dst_s (shared memory).
__device__ void left_mul(const uint32_t* src, const uint32_t* __restrict__ wl,
                         const uint32_t* __restrict__ tw, uint32_t* dst_s,
                         int64_t* __restrict__ dst_g, int n1, int n2, uint32_t q,
                         uint64_t r64) {
  const int groups = blockDim.x / n1;
  const int g = threadIdx.x / n1;
  const int c = threadIdx.x % n1;
  for (int r0 = g * kRows; r0 < n2; r0 += groups * kRows) {
    uint64_t lo[kRows];
    uint32_t hi[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      lo[j] = 0;
      hi[j] = 0;
    }
    for (int k = 0; k < n2; k += 4) {
      const uint32_t x0 = src[(k + 0) * n1 + c];
      const uint32_t x1 = src[(k + 1) * n1 + c];
      const uint32_t x2 = src[(k + 2) * n1 + c];
      const uint32_t x3 = src[(k + 3) * n1 + c];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(wl + (r0 + j) * n2 + k));
        mac(lo[j], hi[j], w.x, x0);
        mac(lo[j], hi[j], w.y, x1);
        mac(lo[j], hi[j], w.z, x2);
        mac(lo[j], hi[j], w.w, x3);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int idx = (r0 + j) * n1 + c;
      uint32_t v = reduce(lo[j], hi[j], q, r64);
      if (tw != nullptr) {
        v = static_cast<uint32_t>(static_cast<uint64_t>(v) * __ldg(tw + idx) % q);
      }
      store(dst_s, dst_g, idx, v);
    }
  }
}

// dst[r][c] = (sum_k src[r][k] * wr[k][c]) * tw[r][c]   (r < n2; k, c < n1)
__device__ void right_mul(const uint32_t* src, const uint32_t* __restrict__ wr,
                          const uint32_t* __restrict__ tw, uint32_t* dst_s,
                          int64_t* __restrict__ dst_g, int n1, int n2, uint32_t q,
                          uint64_t r64) {
  const int groups = blockDim.x / n1;
  const int g = threadIdx.x / n1;
  const int c = threadIdx.x % n1;
  for (int r0 = g * kRows; r0 < n2; r0 += groups * kRows) {
    uint64_t lo[kRows];
    uint32_t hi[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      lo[j] = 0;
      hi[j] = 0;
    }
    for (int k = 0; k < n1; k += 4) {
      const uint32_t w0 = __ldg(wr + (k + 0) * n1 + c);
      const uint32_t w1 = __ldg(wr + (k + 1) * n1 + c);
      const uint32_t w2 = __ldg(wr + (k + 2) * n1 + c);
      const uint32_t w3 = __ldg(wr + (k + 3) * n1 + c);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const uint4 x = *reinterpret_cast<const uint4*>(src + (r0 + j) * n1 + k);
        mac(lo[j], hi[j], x.x, w0);
        mac(lo[j], hi[j], x.y, w1);
        mac(lo[j], hi[j], x.z, w2);
        mac(lo[j], hi[j], x.w, w3);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int idx = (r0 + j) * n1 + c;
      uint32_t v = reduce(lo[j], hi[j], q, r64);
      if (tw != nullptr) {
        v = static_cast<uint32_t>(static_cast<uint64_t>(v) * __ldg(tw + idx) % q);
      }
      store(dst_s, dst_g, idx, v);
    }
  }
}

// grid (B, L): block (b, l) transforms x[l][b][:] into out[l][b][:].
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
four_step_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                 const uint32_t* __restrict__ wl, const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ wr, const uint32_t* __restrict__ moduli,
                 int B, int n1, int n2) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = n1 * n2;
  uint32_t* s0 = smem;
  uint32_t* s1 = smem + n;
  const int l = blockIdx.y;
  const int64_t poly = static_cast<int64_t>(l) * B + blockIdx.x;
  const int64_t* xp = x + poly * n;
  int64_t* op = out + poly * n;
  const uint32_t q = moduli[l];
  const uint64_t r64 = (~0ull % q + 1) % q;
  wl += static_cast<int64_t>(l) * n2 * n2;
  tw += static_cast<int64_t>(l) * n2 * n1;
  wr += static_cast<int64_t>(l) * n1 * n1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s0[i] = static_cast<uint32_t>(xp[i]);
  }
  __syncthreads();
  if (!kInverse) {
    left_mul(s0, wl, tw, s1, nullptr, n1, n2, q, r64);
    __syncthreads();
    right_mul(s1, wr, nullptr, nullptr, op, n1, n2, q, r64);
  } else {
    right_mul(s0, wr, tw, s1, nullptr, n1, n2, q, r64);
    __syncthreads();
    left_mul(s1, wl, nullptr, nullptr, op, n1, n2, q, r64);
  }
}

template <bool kInverse>
cudaError_t launch(const int64_t* x, int64_t* out, const uint32_t* wl, const uint32_t* tw,
                   const uint32_t* wr, const uint32_t* moduli, int L, int B, int n1, int n2,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n1) * n2 * sizeof(uint32_t);
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t err = cudaFuncSetAttribute(four_step_kernel<kInverse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(L));
  four_step_kernel<kInverse><<<grid, kThreads, smem, stream>>>(x, out, wl, tw, wr, moduli, B,
                                                               n1, n2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. x and out are int64 [L][B][n]; wl [L][n2][n2],
// tw [L][n2][n1], wr [L][n1][n1] and moduli [L] are 32-bit. The forward
// transform takes (W2, T, W1), the inverse (W2^-1, T^-1, W1^-1). Returns
// the launch's cudaError_t (0 on success); the caller checks shapes and
// bounds before the call.
extern "C" int mxx_four_step_ntt(const void* x, void* out, const void* wl, const void* tw,
                                 const void* wr, const void* moduli, int L, int B, int n1,
                                 int n2, int inverse, void* stream) {
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  const auto* wli = static_cast<const uint32_t*>(wl);
  const auto* twi = static_cast<const uint32_t*>(tw);
  const auto* wri = static_cast<const uint32_t*>(wr);
  const auto* qi = static_cast<const uint32_t*>(moduli);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = inverse
                              ? launch<true>(xi, oi, wli, twi, wri, qi, L, B, n1, n2, s)
                              : launch<false>(xi, oi, wli, twi, wri, qi, L, B, n1, n2, s);
  return static_cast<int>(err);
}
