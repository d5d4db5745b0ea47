// ChaCha20 keystream (RFC 8439 block function) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes ChaCha20 in jnp
// (mxx_tpu/sampler/chacha.py), and its plain PyTorch twin is
// mxx_tpu_torch/sampler/chacha.py:_chacha_words, four quarter rounds per
// tensor op, about 650 int64 ops per draw. It was added because that twin
// held most of a trapdoor preimage's time on the card: its ops ran about
// 300 times above the block function's bound and left the device idle
// between them (PERF.md). This kernel writes the same words, bit for bit.
//
// Work: key k (of nkeys, each 8 words in [0, 2^32) held as int64) makes
// nblocks blocks b = 0 .. nblocks-1. Block (k, b) has the state
//   [4 constants, key k, counter, nonce0, nonce1, nonce2]
// with counter = counters[k * nblocks + b] where a counter array is given,
// else counter0 + b (mod 2^32). Its 16 final words (20 rounds, then the
// feed-forward) go to row k of out [nkeys][nwords], word w of the block at
// w * nblocks + b (word index major across the key's blocks); an index at
// or past nwords is not written (nwords <= 16 nblocks). Each output is an
// int64 in [0, 2^32).
//
// What bounds it on this card: the integer ALU pipe. A block is 80 quarter
// rounds of 4 adds, 4 xors and 4 rotates plus the feed-forward, against 64
// bytes of keystream, 128 bytes as int64. Its sm_90a SASS issues 1,276
// instructions a block: 740 on the ALU pipe (the 320 xors as LOP3, the 320
// rotates as SHF, the index and store checks), 434 on the FMA pipe (ptxas
// issues the adds as IMAD.IADD). At 64 ALU lanes an SM (16.7e12/s) and
// 3.35 TB/s the ALU pipe takes about 1.16x the stores' time.
// What the design does about it: one thread makes one block, with the
// 16-word state, the key, the counter and the nonces in registers as
// uint32; every rotate is one funnel shift; the 20 rounds are unrolled; the
// only memory traffic is the key's 8 words (one line, shared by the key's
// blocks through the cache) and one store of each final word, straight into
// the caller's layout: neighbouring threads hold neighbouring blocks of a
// key, so each of the 16 stores of a warp covers 256 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }

__device__ __forceinline__ void quarter_round(uint32_t& a, uint32_t& b, uint32_t& c,
                                              uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

__global__ void __launch_bounds__(kThreads)
chacha20_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ counters,
                int64_t* __restrict__ out, long long nkeys, long long nblocks,
                long long nwords, uint32_t counter0, uint32_t nonce0, uint32_t nonce1,
                uint32_t nonce2) {
  const long long total = nkeys * nblocks;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < total;
       g += stride) {
    const long long k = nkeys == 1 ? 0 : g / nblocks;
    const long long b = g - k * nblocks;
    uint32_t key[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) key[i] = static_cast<uint32_t>(__ldg(keys + k * 8 + i));
    const uint32_t ctr = counters ? static_cast<uint32_t>(__ldg(counters + g))
                                  : counter0 + static_cast<uint32_t>(b);
    const uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                               key[0], key[1], key[2], key[3],
                               key[4], key[5], key[6], key[7],
                               ctr, nonce0, nonce1, nonce2};
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      quarter_round(x[0], x[4], x[8], x[12]);
      quarter_round(x[1], x[5], x[9], x[13]);
      quarter_round(x[2], x[6], x[10], x[14]);
      quarter_round(x[3], x[7], x[11], x[15]);
      quarter_round(x[0], x[5], x[10], x[15]);
      quarter_round(x[1], x[6], x[11], x[12]);
      quarter_round(x[2], x[7], x[8], x[13]);
      quarter_round(x[3], x[4], x[9], x[14]);
    }
    int64_t* row = out + k * nwords;
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const long long at = w * nblocks + b;
      if (at < nwords) row[at] = static_cast<int64_t>(x[w] + init[w]);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); counters may be null. Returns the
// launch's cudaError_t (0 on success).
extern "C" int mxx_chacha20(const void* keys, const void* counters, void* out, long long nkeys,
                            long long nblocks, long long nwords, unsigned int counter0,
                            unsigned int nonce0, unsigned int nonce1, unsigned int nonce2,
                            void* stream) {
  if (nkeys <= 0 || nblocks <= 0 || nwords <= 0 || nwords > 16 * nblocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = nkeys * nblocks;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(want < (1LL << 30) ? want : (1LL << 30));
  chacha20_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(counters),
      static_cast<int64_t*>(out), nkeys, nblocks, nwords, counter0, nonce0, nonce1, nonce2);
  return static_cast<int>(cudaGetLastError());
}
