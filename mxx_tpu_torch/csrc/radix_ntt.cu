// Radix-2 merged-twist forward negacyclic NTT over CRT limbs, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxx_tpu/ops/pallas_ntt.py: _fwd_head_kernel,
// launched by _head_call for ntt_fwd_head_pallas and ntt_fwd_hybrid. It
// computes what that kernel computes, bit for bit: the Cooley-Tukey stages
// of the merged-twist forward transform (natural coefficients in, bit-reversed
// evaluations out), stage m (pair distance t = n / 2m) taking each block
//   a = x[2 i t + k], b = x[2 i t + t + k], w = psi_rev[m + i]   (i < m, k < t)
// to (a + w b, a - w b) mod q.
//
// The TPU version stops at t = 128: Mosaic cannot reshape below the 128-wide
// lane dimension, so jnp finishes the stages with t < 128. Nothing on this
// card imposes that split. The kernel takes the smallest pair distance as an
// argument: t_min = 128 is the TPU kernel (ntt_fwd_head), t_min = 1 runs all
// log2(n) stages in one launch (ntt_fwd_hybrid). The 8-poly tile of the TPU
// grid is not carried over either.
//
// One thread block transforms one (limb, poly) pair. The poly stays in
// shared memory as uint32 through every stage (4n bytes, 64 KB at n = 16384),
// so device memory sees the int64 input and output once. The modular products
// are Shoup multiplications with a per-twiddle quotient table built on the
// host (wq = floor(w 2^32 / q)): one 32-bit high multiply, two low multiplies
// and one conditional subtraction, exact for q < 2^31.
//
// Bounds on this card: q < 2^31 (residues and sums a + wb < 2q fit in 32
// bits); 256 <= n <= 16384, a power of two (the buffer fits the 227 KB a block
// can have; n/2 butterflies per stage over at most kMaxThreads threads).
// What bounds it: device memory for the int64 input and output (16 bytes per
// coefficient) against log2(n) stages of shared-memory butterflies (16 bytes
// of shared-memory traffic and ~12 integer instructions per butterfly).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

// b * w mod q for b, w < q < 2^31 and wq = floor(w * 2^32 / q)
__device__ __forceinline__ uint32_t mul_shoup(uint32_t b, uint32_t w, uint32_t wq, uint32_t q) {
  const uint32_t hi = __umulhi(b, wq);
  const uint32_t r = b * w - hi * q;  // exact mod 2^32, in [0, 2q)
  return r >= q ? r - q : r;
}

// grid (B, L): block (b, l) transforms x[l][b][:] into out[l][b][:]
__global__ void __launch_bounds__(kMaxThreads)
radix_ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_shoup,
                     const uint32_t* __restrict__ moduli, int B, int log_n, int t_min) {
  extern __shared__ __align__(16) uint32_t s[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const int l = blockIdx.y;
  const int64_t poly = static_cast<int64_t>(l) * B + blockIdx.x;
  const int64_t* xp = x + poly * n;
  int64_t* op = out + poly * n;
  const uint32_t q = moduli[l];
  psi += static_cast<int64_t>(l) * n;
  psi_shoup += static_cast<int64_t>(l) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = static_cast<uint32_t>(xp[i]);
  }
  __syncthreads();
  // stage m = 1, 2, 4, ... has pair distance t = n / 2m = 2^log_t
  for (int log_t = log_n - 1, m = 1; log_t >= 0 && (1 << log_t) >= t_min; --log_t, m <<= 1) {
    const int t = 1 << log_t;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int i = j >> log_t;  // block of the stage, < m
      const int ia = (i << (log_t + 1)) + (j & (t - 1));
      const uint32_t a = s[ia];
      const uint32_t wb = mul_shoup(s[ia + t], __ldg(psi + m + i), __ldg(psi_shoup + m + i), q);
      const uint32_t sum = a + wb;
      s[ia] = sum >= q ? sum - q : sum;
      s[ia + t] = a >= wb ? a - wb : a + (q - wb);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    op[i] = s[i];
  }
}

}  // namespace

// Plain C entry for ctypes. x and out are int64 [L][B][n] (n = 2^log_n);
// psi and psi_shoup are uint32 [L][n] (standard-form psi_rev and its Shoup
// quotients), moduli uint32 [L]. Runs the stages with pair distance
// t >= t_min. Returns the launch's cudaError_t (0 on success); the caller
// checks shapes and bounds before the call.
extern "C" int mxx_radix_ntt_fwd(const void* x, void* out, const void* psi, const void* psi_shoup,
                                 const void* moduli, int L, int B, int log_n, int t_min,
                                 void* stream) {
  const int n = 1 << log_n;
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t err = cudaFuncSetAttribute(radix_ntt_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(L));
  radix_ntt_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_shoup),
      static_cast<const uint32_t*>(moduli), B, log_n, t_min);
  return static_cast<int>(cudaGetLastError());
}
