// Host walk of a Threefry-2x32 key chain (the port's core/random.py
// draws, bit for bit with jax.random under jax_threefry_partitionable).
//
// DeepLearning's step loop (h2o3_tpu/models/deeplearning.py:362) starts
// every minibatch with `key, kidx, kdrop = split(key, 3)`: a chain, each
// step's key made from the one before. The chain is cheap scalar work
// and sequential, so it runs here on the host; the draws it keys (batch
// rows, dropout masks) then run on the device, a chunk of steps in one
// vectorised call.
//
// split(key, n)[i] hashes the counter pair (0, i) under key.

#include <cstdint>

namespace {

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                         uint32_t* y0, uint32_t* y1) {
  static const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

}  // namespace

extern "C" {

// Walk `steps` links of the chain key <- split(key, num)[0] from
// (k0, k1). out receives, per step, the other num - 1 subkeys as word
// pairs: out[(s * (num - 1) + j - 1) * 2 + w] is word w of
// split(key_s, num)[j]. key_out receives the key after the last step.
void h2o_split_chain(uint32_t k0, uint32_t k1, int64_t steps, int32_t num,
                     uint32_t* out, uint32_t* key_out) {
  for (int64_t s = 0; s < steps; ++s) {
    uint32_t* row = out + s * (num - 1) * 2;
    for (int32_t j = 1; j < num; ++j)
      threefry2x32(k0, k1, 0u, static_cast<uint32_t>(j), row + (j - 1) * 2,
                   row + (j - 1) * 2 + 1);
    uint32_t n0, n1;
    threefry2x32(k0, k1, 0u, 0u, &n0, &n1);
    k0 = n0;
    k1 = n1;
  }
  key_out[0] = k0;
  key_out[1] = k1;
}

}  // extern "C"
