// Tree-histogram gather -> accumulate for Hopper (sm_90a).
//
// Replaces the Pallas kernel h2o3_tpu/models/tree/pallas_hist.py
// `_build_gather` (kernel body :339-357, pallas_call :362), entered there
// through `hist_gather` (:416). Same function: for every row r with node
// n_r in [0, S) and every feature f, add (w, w*y, w*y*y) of the row into
// the bucket at flat index n_r*TB + offsets[f] + bin[r, f] of an
// (S*TB, 3) f32 histogram. Rows whose node lies outside [0, S) (dead
// rows, node -1) contribute nothing.
//
// Bound on this card: memory. Per launch the function must read every
// row's node, the bins, w and y of the rows inside [0, S) and write the
// 12*S*TB-byte histogram; it does about 3*n*F adds. At the flagship level
// shapes (n = 1M, F = 10, uint8 bins) that is ~19.3 MB, ~5.8 us at
// 3.35 TB/s.
//
// Determinism: a seeded GBM must grow the same trees on every run, and
// tiled must equal untiled bit for bit. The sums are int64 fixed point,
// which is associative, so any order of atomic adds gives the same bits,
// and the plain version in models/tree/hist_gather.py computes the very
// same integers (the convention is written out there). Three launches
// from one C entry point, on the caller's stream, no sync:
//   * Pass 0 (hist_scale_kernel): a grid-stride max of |w|, |w*y| and
//     |(w*y)*y| over all n rows, merged across blocks with integer
//     atomicMax on the float bits (valid for non-negative floats; Inf and
//     NaN order above every finite value). Passes 1 and 2 derive each
//     channel's k_c = 62 - e_c - b from these maxima with the same
//     function, so the host never reads them.
//   * Pass 1 (hist_accumulate_kernel): block (g, t) owns the rows
//     [g*rows_per_cta, (g+1)*rows_per_cta) and node tile t. It zeroes a
//     tile_S*TB*3 accumulator of 64-bit sums in shared memory (24 B a
//     bucket). One thread per row, kUnroll rows per thread with their
//     node, w, y and first bin loaded before any is used, so several
//     loads are in flight; the bins are read byte by byte through L1, or
//     as 16-byte vectors where a row is 16 or 32 bytes (the flagship's
//     10-byte rows are not); each row is quantised once (__double2ll_rn,
//     round half to even) and its F buckets take one exact 64-bit shared
//     add per non-zero channel (shared_add64). The block then adds each
//     non-zero sum into the global int64 accumulator (REDG.E.ADD.64);
//     adding zero is the identity, so skipping it changes nothing. When
//     one slot does not fit in shared memory (tile_S == 0) the same pass
//     adds every row straight into the global accumulator instead.
//   * Pass 2 (hist_finalise_kernel): float(double(Q) * 2^-k_c), or NaN
//     for a channel whose maximum is not finite.
// The shared 64-bit add: cuobjdump -sass of the sm_90a build shows that
// atomicAdd on a shared unsigned long long compiles to ATOMS.CAST.SPIN.64,
// a compare-and-swap loop, not ATOMS.ADD.64. So each shared sum is two
// 32-bit words added with the native ATOMS.ADD, the carry taken from the
// low word's returned old value (shared_add64). On an H100 80GB HBM3 at
// the flagship level shapes, `python3 -m h2o3_tpu_torch.kernel_variants`
// timed this pass at 53-72 us against 115-207 us with the 64-bit
// compare-and-swap loop, and at 22-24 us with no shared adds at all.
//
// What it leaves on the table: two shared atomics per 64-bit add (the
// adds, not the loads, take most of pass 1); the bins are read with plain
// loads (not cp.async or TMA staging); blocks merge their partials
// through L2 atomics (not through a cluster's distributed shared memory);
// and the scale pass reads w and y once more on every launch (it could be
// cached per tree).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kScaleThreads = 256;     // pass 0
constexpr int kScaleBlocks = 1056;     // at most 8 blocks per SM of 132
constexpr int kThreads = 512;          // pass 1
constexpr int kUnroll = 4;             // rows per thread in flight
constexpr int kFinaliseThreads = 256;  // pass 2
constexpr unsigned kInfBits = 0x7f800000u;

// k_c of the convention from the channel maximum's float bits; false when
// the maximum is Inf or NaN.
__device__ __forceinline__ bool channel_exponent(unsigned bits, int b,
                                                 int* k) {
  if (bits >= kInfBits) return false;
  int e;
  frexp((double)__uint_as_float(bits), &e);
  *k = 62 - e - b;
  return true;
}

__device__ __forceinline__ long long quantise(float v, double scale) {
  return scale == 0.0 ? 0 : __double2ll_rn((double)v * scale);
}

// One exact 64-bit add into a (low, high) pair of shared 32-bit words.
// atomicAdd on a shared 64-bit word compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64) on sm_90a; the 32-bit ATOMS.ADD is native. The low
// word's add returns its old value, which says whether this add carried
// out of it, and the high word takes the high half of q plus that carry.
// So the pair holds the exact 64-bit sum (mod 2^64) in any order of adds.
__device__ __forceinline__ void shared_add64(unsigned* p, long long q) {
  const unsigned lo = (unsigned)(u64)q;
  const unsigned hi = (unsigned)((u64)q >> 32);
  const unsigned old = atomicAdd(p, lo);
  const unsigned carried = hi + ((unsigned)(old + lo) < lo ? 1u : 0u);
  if (carried) atomicAdd(p + 1, carried);
}

__global__ void __launch_bounds__(kScaleThreads)
hist_scale_kernel(const float* __restrict__ w, const float* __restrict__ y,
                  int64_t n, unsigned* __restrict__ maxbits) {
  unsigned m[3] = {0u, 0u, 0u};
  const int64_t stride = (int64_t)gridDim.x * kScaleThreads;
  for (int64_t r = (int64_t)blockIdx.x * kScaleThreads + threadIdx.x; r < n;
       r += stride) {
    const float wv = __ldg(w + r), yv = __ldg(y + r);
    const float wy = wv * yv;
    const float wyy = wy * yv;          // (w*y)*y, the reference's order
    m[0] = max(m[0], __float_as_uint(fabsf(wv)));
    m[1] = max(m[1], __float_as_uint(fabsf(wy)));
    m[2] = max(m[2], __float_as_uint(fabsf(wyy)));
  }
  __shared__ unsigned part[3][kScaleThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned v = __reduce_max_sync(0xffffffffu, m[c]);
    if (lane == 0) part[c][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned v = 0u;
    for (int i = 0; i < kScaleThreads / 32; ++i)
      v = max(v, part[threadIdx.x][i]);
    if (v) atomicMax(maxbits + threadIdx.x, v);
  }
}

template <typename BinT, bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
hist_accumulate_kernel(const BinT* __restrict__ binned,
                       const int32_t* __restrict__ node,
                       const float* __restrict__ w,
                       const float* __restrict__ y,
                       const int32_t* __restrict__ offsets,
                       int64_t n, int F, int TB, int S, int tile_S,
                       int64_t rows_per_cta, int b,
                       const unsigned* __restrict__ maxbits,
                       u64* __restrict__ acc) {
  extern __shared__ unsigned sacc[];     // (low, high) word per sum
  const int lo = kShared ? (int)blockIdx.y * tile_S : 0;
  const int hi = kShared ? min(S, lo + tile_S) : S;
  const int len = kShared ? (hi - lo) * TB * 3 : 0;
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * len; i += kThreads) sacc[i] = 0u;
    __syncthreads();
  }
  double scale[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int k;
    scale[c] = channel_exponent(__ldg(maxbits + c), b, &k) ? ldexp(1.0, k)
                                                          : 0.0;
  }

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r1 = min(n, r0 + rows_per_cta);
  for (int64_t r = r0 + threadIdx.x; r < r1;
       r += (int64_t)kThreads * kUnroll) {
    int nd[kUnroll], b0[kUnroll];
    float wv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + (int64_t)u * kThreads;
      nd[u] = -1;
      b0[u] = 0;
      wv[u] = 0.f;
      yv[u] = 0.f;
      if (ru < r1) {
        nd[u] = __ldg(node + ru);
        wv[u] = __ldg(w + ru);
        yv[u] = __ldg(y + ru);
        b0[u] = (int)__ldg(binned + ru * F);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (nd[u] < lo || nd[u] >= hi) continue;
      const float wy = wv[u] * yv[u];
      const float wyy = wy * yv[u];
      const long long q0 = quantise(wv[u], scale[0]);
      const long long q1 = quantise(wy, scale[1]);
      const long long q2 = quantise(wyy, scale[2]);
      if ((q0 | q1 | q2) == 0) continue;
      const BinT* row = binned + (r + (int64_t)u * kThreads) * F;
      const int64_t base = (int64_t)(nd[u] - lo) * TB;
      auto add = [&](int f, int bin) {
        const int64_t i = 3 * (base + __ldg(offsets + f) + bin);
        if (kShared) {
          if (q0) shared_add64(sacc + 2 * i, q0);
          if (q1) shared_add64(sacc + 2 * i + 2, q1);
          if (q2) shared_add64(sacc + 2 * i + 4, q2);
        } else {
          if (q0) atomicAdd(acc + i, (u64)q0);
          if (q1) atomicAdd(acc + i + 1, (u64)q1);
          if (q2) atomicAdd(acc + i + 2, (u64)q2);
        }
      };
      if (kVec) {             // a 16- or 32-byte row, 16-byte aligned
        const uint4* rv = reinterpret_cast<const uint4*>(row);
        uint4 v[2] = {__ldg(rv), make_uint4(0u, 0u, 0u, 0u)};
        if (F * (int)sizeof(BinT) > 16) v[1] = __ldg(rv + 1);
        const BinT* bins = reinterpret_cast<const BinT*>(v);
#pragma unroll
        for (int f = 0; f < 32 / (int)sizeof(BinT); ++f)
          if (f < F) add(f, (int)bins[f]);
      } else {
        for (int f = 0; f < F; ++f)
          add(f, f == 0 ? b0[u] : (int)__ldg(row + f));
      }
    }
  }

  if (kShared) {
    __syncthreads();
    u64* dst = acc + (int64_t)lo * TB * 3;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const u64 v = ((u64)sacc[2 * i + 1] << 32) | sacc[2 * i];
      if (v) atomicAdd(dst + i, v);
    }
  }
}

__global__ void __launch_bounds__(kFinaliseThreads)
hist_finalise_kernel(const long long* __restrict__ acc, int64_t len, int b,
                     const unsigned* __restrict__ maxbits,
                     float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kFinaliseThreads + threadIdx.x;
  if (i >= len) return;
  int k;
  out[i] = channel_exponent(__ldg(maxbits + i % 3), b, &k)
               ? __double2float_rn(ldexp((double)acc[i], -k))
               : __int_as_float(0x7fc00000);
}

// What pass 1 is launched with.
struct AccumulateArgs {
  const void *binned, *node, *w, *y, *offsets;
  int64_t n;
  int F, TB, S, tile_S, n_tiles;
  int64_t rows_per_cta;
  int G, b;
  const unsigned* maxbits;
  u64* acc;
  cudaStream_t st;
};

template <typename BinT, bool kShared, bool kVec>
void launch_accumulate(const AccumulateArgs& a, dim3 grid, size_t smem) {
  hist_accumulate_kernel<BinT, kShared, kVec><<<grid, kThreads, smem,
                                                a.st>>>(
      (const BinT*)a.binned, (const int32_t*)a.node, (const float*)a.w,
      (const float*)a.y, (const int32_t*)a.offsets, a.n, a.F, a.TB, a.S,
      a.tile_S, a.rows_per_cta, a.b, a.maxbits, a.acc);
}

template <typename BinT, bool kVec>
cudaError_t accumulate(const AccumulateArgs& a) {
  if (a.tile_S > 0) {
    const size_t smem = (size_t)a.tile_S * a.TB * 3 * 2 * sizeof(unsigned);
    cudaError_t err = cudaFuncSetAttribute(
        hist_accumulate_kernel<BinT, true, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    launch_accumulate<BinT, true, kVec>(a, dim3(a.G, a.n_tiles), smem);
  } else {
    launch_accumulate<BinT, false, kVec>(a, dim3(a.G, 1), 0);
  }
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t accumulate(const AccumulateArgs& a, bool vec) {
  return vec ? accumulate<BinT, true>(a) : accumulate<BinT, false>(a);
}

}  // namespace

// Runs the passes selected by the bit mask `passes` (1 scale, 2
// accumulate, 4 finalise; 7 for the whole function) on `stream` and
// returns cudaGetLastError() (0 on success). bin_bytes is the element
// size of `binned` (1 uint8, 2 int16, 4 int32). `scratch` holds 2 + S*TB*3
// int64, zeroed by the caller: the channel maxima's float bits in its
// first 12 bytes, then the bucket sums. tile_S == 0 accumulates without a
// shared-memory tile. b = ceil(log2(max(n, 1))). out holds S*TB*3 f32.
extern "C" int hist_gather_launch(const void* binned, int bin_bytes,
                                  const void* node, const void* w,
                                  const void* y, const void* offsets,
                                  int64_t n, int F, int TB, int S,
                                  int tile_S, int n_tiles,
                                  int64_t rows_per_cta, int G, int b,
                                  int passes, void* scratch, void* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* maxbits = (unsigned*)scratch;
  u64* acc = (u64*)scratch + 2;
  cudaError_t err;
  if (passes & 1) {
    const int64_t want = (n + kScaleThreads - 1) / kScaleThreads;
    const int blocks = (int)(want < kScaleBlocks ? want : kScaleBlocks);
    if (blocks > 0)
      hist_scale_kernel<<<blocks, kScaleThreads, 0, st>>>(
          (const float*)w, (const float*)y, n, maxbits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const AccumulateArgs a{binned, node, w, y, offsets, n, F, TB, S, tile_S,
                           n_tiles, rows_per_cta, G, b, maxbits, acc, st};
    // whole rows of 16 or 32 bytes at a 16-byte aligned base: vector loads
    const int row_bytes = F * bin_bytes;
    const bool vec = (row_bytes == 16 || row_bytes == 32) &&
                     (uintptr_t)binned % 16 == 0;
    switch (bin_bytes) {
      case 1: err = accumulate<uint8_t>(a, vec); break;
      case 2: err = accumulate<int16_t>(a, vec); break;
      case 4: err = accumulate<int32_t>(a, vec); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const int64_t len = (int64_t)S * TB * 3;
    const int blocks = (int)((len + kFinaliseThreads - 1) / kFinaliseThreads);
    if (blocks > 0)
      hist_finalise_kernel<<<blocks, kFinaliseThreads, 0, st>>>(
          (const long long*)acc, len, b, maxbits, (float*)out);
  }
  return (int)cudaGetLastError();
}
