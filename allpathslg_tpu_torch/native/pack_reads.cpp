// Read packing for the uploads to the device (host hot path of every
// stage that uploads reads).
//
// The layout of dtypes/packed.py, bit for bit as the reference's numpy
// packing (allpathslg_tpu/dtypes/packed.py) gives it:
//   pack_codes: [n, L] uint8 codes -> words [n, ceil(L/16)] uint32, base j
//     as (code & 3) at bits 2*(j%16) of word j/16, and nmask
//     [n, ceil(L/32)] uint32, bit j%32 of word j/32 set where the code is
//     exactly 4; bits past L are 0.
//   qual_palette: the sorted distinct values of [n, L] uint8 quals (a
//     256-entry table of the values seen, read in order).
//   pack_nibbles: each qual's rank in a sorted palette of <= 16 values, at
//     bits 4*(j%8) of word j/8; bits past L are 0.
// Row i starts `stride` bytes after row i-1 and holds its L bytes
// contiguously. pack_codes reads each row once, 32 bytes at a time; quals
// are read twice, for the palette and then for the nibbles.
//
// Exposed through a C ABI for ctypes; built by allpathslg_tpu_torch.native.
// build. ctypes releases the GIL for the call, so two threads pack at once.

#include <cstdint>
#include <cstring>

#if __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "pack_reads.cpp reads eight bases as one little-endian word"
#endif

namespace {

constexpr uint64_t kLow2 = 0x0303030303030303ULL;
constexpr uint64_t kFours = 0x0404040404040404ULL;
constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;

// Eight codes (byte k = base k) -> 16 bits, base k's (code & 3) at 2k.
inline uint32_t pack8(uint64_t x) {
    x &= kLow2;
    x = (x | (x >> 6)) & 0x000F000F000F000FULL;
    x = (x | (x >> 12)) & 0x000000FF000000FFULL;
    x = (x | (x >> 24)) & 0xFFFFULL;
    return (uint32_t)x;
}

// Eight codes -> 8 bits, bit k set where byte k is exactly 4. `z` holds
// 0x80 in each byte of x ^ 4 that is zero (no carry crosses a byte); the
// multiply moves byte k's flag to bit 56 + k, and its other products land
// on distinct bits outside 56..63.
inline uint32_t nmask8(uint64_t x) {
    uint64_t t = x ^ kFours;
    uint64_t z = ~(((t & kLow7) + kLow7) | t | kLow7);
    return (uint32_t)(((z >> 7) * 0x0102040810204080ULL) >> 56);
}

// 32 bytes of row from `j`, zero past L.
inline void load32(const uint8_t* row, int64_t j, int64_t L,
                   uint64_t x[4]) {
    if (j + 32 <= L) {
        memcpy(x, row + j, 32);
    } else {
        uint8_t buf[32] = {0};
        memcpy(buf, row + j, (size_t)(L - j));
        memcpy(x, buf, 32);
    }
}

}  // namespace

extern "C" {

void pack_codes(const uint8_t* codes, int64_t n, int64_t L, int64_t stride,
                uint32_t* words, uint32_t* nmask) {
    const int64_t Wb = (L + 15) / 16, Wn = (L + 31) / 32;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = codes + i * stride;
        uint32_t* w = words + i * Wb;
        uint32_t* m = nmask + i * Wn;
        for (int64_t b = 0; b < Wn; ++b) {
            uint64_t x[4];
            load32(row, 32 * b, L, x);
            w[2 * b] = pack8(x[0]) | (pack8(x[1]) << 16);
            if (2 * b + 1 < Wb)
                w[2 * b + 1] = pack8(x[2]) | (pack8(x[3]) << 16);
            m[b] = nmask8(x[0]) | (nmask8(x[1]) << 8) | (nmask8(x[2]) << 16) |
                   (nmask8(x[3]) << 24);
        }
    }
}

// The distinct values in ascending order into palette[0..count); returns
// count (0..256).
int qual_palette(const uint8_t* quals, int64_t n, int64_t L, int64_t stride,
                 uint8_t* palette) {
    uint8_t seen[256] = {0};
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = quals + i * stride;
        for (int64_t j = 0; j < L; ++j) seen[row[j]] = 1;
    }
    int count = 0;
    for (int v = 0; v < 256; ++v)
        if (seen[v]) palette[count++] = (uint8_t)v;
    return count;
}

void pack_nibbles(const uint8_t* quals, int64_t n, int64_t L, int64_t stride,
                  const uint8_t* palette, int count, uint32_t* nibbles) {
    uint32_t rank[256] = {0};
    for (int r = 0; r < count; ++r) rank[palette[r]] = (uint32_t)r;
    const int64_t Wq = (L + 7) / 8;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = quals + i * stride;
        uint32_t* out = nibbles + i * Wq;
        int64_t w = 0;
        for (; 8 * w + 8 <= L; ++w) {
            const uint8_t* q = row + 8 * w;
            out[w] = rank[q[0]] | (rank[q[1]] << 4) | (rank[q[2]] << 8) |
                     (rank[q[3]] << 12) | (rank[q[4]] << 16) |
                     (rank[q[5]] << 20) | (rank[q[6]] << 24) |
                     (rank[q[7]] << 28);
        }
        if (w < Wq) {
            uint32_t v = 0;
            for (int64_t j = 8 * w; j < L; ++j)
                v |= rank[row[j]] << (4 * (j - 8 * w));
            out[w] = v;
        }
    }
}

}  // extern "C"
