// Host bit-packing codec for compact matrix serialization.
//
// A copy of the JAX package's `native/codec.cpp`, built separately for the
// port (mxx_tpu_torch/native/codec.py). Residues are < 2^crt_bits, so packing
// each uint32 to `bits` bits shrinks artifacts by 32/bits. Plain C ABI,
// loaded with ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libcodec.so codec.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// Pack `count` uint32 values (each < 2^bits, bits <= 32) into a little-endian
// bitstream. `out` must hold at least (count*bits + 7) / 8 bytes.
void mxx_pack_u32(const uint32_t* in, uint64_t count, uint32_t bits, uint8_t* out) {
    uint64_t acc = 0;
    uint32_t acc_bits = 0;
    uint8_t* p = out;
    for (uint64_t i = 0; i < count; ++i) {
        acc |= (uint64_t)(in[i] & ((bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u)))
               << acc_bits;
        acc_bits += bits;
        while (acc_bits >= 8) {
            *p++ = (uint8_t)(acc & 0xFF);
            acc >>= 8;
            acc_bits -= 8;
        }
    }
    if (acc_bits > 0) {
        *p++ = (uint8_t)(acc & 0xFF);
    }
}

// Unpack `count` values of `bits` bits from the little-endian bitstream.
void mxx_unpack_u32(const uint8_t* in, uint64_t count, uint32_t bits, uint32_t* out) {
    uint64_t acc = 0;
    uint32_t acc_bits = 0;
    const uint8_t* p = in;
    const uint64_t mask = (bits == 32) ? 0xFFFFFFFFull : ((1ull << bits) - 1ull);
    for (uint64_t i = 0; i < count; ++i) {
        while (acc_bits < bits) {
            acc |= (uint64_t)(*p++) << acc_bits;
            acc_bits += 8;
        }
        out[i] = (uint32_t)(acc & mask);
        acc >>= bits;
        acc_bits -= bits;
    }
}

uint64_t mxx_packed_size(uint64_t count, uint32_t bits) {
    return (count * (uint64_t)bits + 7) / 8;
}

}  // extern "C"
