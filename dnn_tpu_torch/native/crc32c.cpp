// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) for the wire
// codec's payload checksum. Two routes with bit-identical results:
//   * the SSE4.2 crc32 instruction, one 64-bit word a step, where the
//     CPU has it (checked once, at load);
//   * slice-by-8, eight 256-entry tables, one 64-bit word a step: a copy
//     of the JAX package's dnn_crc32c (dnn_tpu/native/codec.cpp), the
//     same tables and the same seed convention.
// dnn_crc32c takes the first route the CPU allows; dnn_crc32c_sliced is
// always the second, so both can be held against each other.
//
// Built at first use by dnn_tpu_torch/native/__init__.py with g++ into
// a plain-C shared library and bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t g_tables[8][256];

// Filled when the library is loaded, so concurrent first calls from
// several threads never race on a lazy initialisation.
struct TableInit {
    TableInit() {
        const uint32_t poly = 0x82f63b78u;
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
            g_tables[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = g_tables[0][i];
            for (int t = 1; t < 8; ++t) {
                c = g_tables[0][c & 0xff] ^ (c >> 8);
                g_tables[t][i] = c;
            }
        }
    }
};
const TableInit g_table_init;

#if defined(__x86_64__)
// The crc32 instruction keeps the same reflected, uninverted state as the
// tables; a word's latency is 3 cycles, so one stream runs at about
// 8 bytes per 3 cycles.
__attribute__((target("sse4.2")))
uint32_t crc32c_sse42(const uint8_t* data, size_t n, uint32_t crc) {
    while (n && (reinterpret_cast<uintptr_t>(data) & 7u)) {
        crc = _mm_crc32_u8(crc, *data++);
        --n;
    }
    uint64_t c = crc;
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, data, 8);
        c = _mm_crc32_u64(c, w);
        data += 8;
        n -= 8;
    }
    crc = static_cast<uint32_t>(c);
    while (n--) crc = _mm_crc32_u8(crc, *data++);
    return crc;
}

bool cpu_has_sse42() {
    __builtin_cpu_init();  // static initialisers may run before libgcc's
    return __builtin_cpu_supports("sse4.2");
}

const bool g_sse42 = cpu_has_sse42();
#else
const bool g_sse42 = false;
#endif

uint32_t crc32c_sliced(const uint8_t* data, size_t n, uint32_t crc) {
    while (n && (reinterpret_cast<uintptr_t>(data) & 7u)) {
        crc = g_tables[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
        --n;
    }
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, data, 8);
        w ^= crc;  // little-endian host
        crc = g_tables[7][w & 0xff] ^
              g_tables[6][(w >> 8) & 0xff] ^
              g_tables[5][(w >> 16) & 0xff] ^
              g_tables[4][(w >> 24) & 0xff] ^
              g_tables[3][(w >> 32) & 0xff] ^
              g_tables[2][(w >> 40) & 0xff] ^
              g_tables[1][(w >> 48) & 0xff] ^
              g_tables[0][(w >> 56) & 0xff];
        data += 8;
        n -= 8;
    }
    while (n--) crc = g_tables[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
    return crc;
}

}  // namespace

extern "C" {

// CRC-32C of `n` bytes at `data`, continuing from `seed` (0 to start).
uint32_t dnn_crc32c(const uint8_t* data, size_t n, uint32_t seed) {
#if defined(__x86_64__)
    if (g_sse42) return ~crc32c_sse42(data, n, ~seed);
#endif
    return ~crc32c_sliced(data, n, ~seed);
}

// The same through the tables, whatever the CPU.
uint32_t dnn_crc32c_sliced(const uint8_t* data, size_t n, uint32_t seed) {
    return ~crc32c_sliced(data, n, ~seed);
}

// 1 when dnn_crc32c runs on the crc32 instruction, else 0.
int dnn_crc32c_hardware() { return g_sse42 ? 1 : 0; }

}  // extern "C"
