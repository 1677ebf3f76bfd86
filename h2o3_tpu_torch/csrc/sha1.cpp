// SHA-1's compression function over whole 64-byte blocks, with its state
// in and out (FIPS 180-4, section 6.1.2).
//
// A digest of a column that no process holds whole: on a row-sharded
// cloud each rank runs its block of bytes through the blocks from the
// state the rank before it ended on, and hands its state and its tail
// (the bytes short of a block) to the next. The last rank pads and
// finishes, so the digest is the one hashlib computes over every row
// in one process. Padding and the hand-over are in native.py.

#include <cstdint>

namespace {

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

void compress(uint32_t* h, const uint8_t* p) {
  uint32_t w[80];
  for (int i = 0; i < 16; ++i) {
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  }
  for (int i = 16; i < 80; ++i) {
    w[i] = rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
  for (int i = 0; i < 80; ++i) {
    uint32_t f, k;
    if (i < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (i < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (i < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    uint32_t t = rotl(a, 5) + f + e + k + w[i];
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = t;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

}  // namespace

extern "C" {

// state: 5 words, updated in place; data: nblocks * 64 bytes.
void h2o_sha1_blocks(uint32_t* state, const uint8_t* data, int64_t nblocks) {
  for (int64_t i = 0; i < nblocks; ++i) compress(state, data + 64 * i);
}

}  // extern "C"
