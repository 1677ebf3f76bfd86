// Tree-histogram gather -> accumulate for Hopper (sm_90a).
//
// Replaces the Pallas kernel h2o3_tpu/models/tree/pallas_hist.py
// `_build_gather` (kernel body :339-357, pallas_call :362), entered there
// through `hist_gather` (:416). Same function: for every row r with node
// n_r in [0, S) and every feature f, add (w, w*y, w*y*y) of the row into
// the f32 bucket at flat index n_r*TB + offsets[f] + bin[r, f] of an
// (S*TB, 3) histogram. Rows whose node lies outside [0, S) (dead rows,
// node -1) contribute nothing.
//
// Bound on this card: memory. Per launch the function must read n*F bin
// bytes (uint8 in the flagship), 12*n bytes of node/w/y and write the
// 12*S*TB-byte histogram; it does about 3*n*F adds. At the flagship level
// shapes (n = 1M, F = 10) that is ~22 MB, ~6.6 us at 3.35 TB/s.
//
// Design, chosen for determinism first (a seeded GBM must grow the same
// trees on every run, and tiled == untiled bit for bit):
//   * Pass 1 (hist_partial_kernel): block (g, t) owns the fixed row range
//     [g*rows_per_cta, (g+1)*rows_per_cta) -- set by n alone, never by the
//     node tile -- and node tile t (slots [t*tile_S, (t+1)*tile_S)). It
//     keeps a tile_S*TB*3 f32 accumulator in shared memory. Warps own
//     disjoint features, so no two warps ever touch the same bucket. A
//     warp walks its row range 32 rows at a time; lanes whose (node, bin)
//     collide are grouped with __match_any_sync and the group's lowest
//     lane adds the group's rows in lane order. Every bucket therefore
//     sums its rows in row order, with no atomics. Rows of other tiles
//     are skipped, which equals the reference's exact w = 0 adds, so the
//     per-block partial of a bucket does not depend on the tiling.
//   * Pass 2 (hist_reduce_kernel): the per-block partials (a scratch
//     buffer the caller allocates) are summed over the row blocks in a
//     fixed order: 8 strided lanes per bucket, then the 8 lane sums in
//     order. Deterministic on every run and independent of tile_S.
// What it leaves on the table (queued as a later optimisation): bins are
// read with plain loads rather than cp.async/TMA, every warp re-reads the
// node/w/y of its rows from L1, and the partials cost G*S*TB*12 bytes of
// extra traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block in pass 1
constexpr int kReduceLanes = 8;    // row-block lanes per bucket in pass 2

template <typename BinT>
__global__ void __launch_bounds__(kWarps * 32)
hist_partial_kernel(const BinT* __restrict__ binned,
                    const int32_t* __restrict__ node,
                    const float* __restrict__ w,
                    const float* __restrict__ y,
                    const int32_t* __restrict__ offsets,
                    int64_t n, int F, int TB, int tile_S,
                    int64_t rows_per_cta, int64_t scratch_stride,
                    float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int acc_len = tile_S * TB * 3;
  float* acc = smem;                                   // (tile_S*TB, 3)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = smem + acc_len + warp * 96;           // this warp's 32 rows

  for (int i = threadIdx.x; i < acc_len; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lo = blockIdx.y * tile_S;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r1 = min(n, r0 + rows_per_cta);

  for (int64_t base = r0; base < r1; base += 32) {
    const int64_t r = base + lane;
    bool in = false;
    int local = 0;
    float wv = 0.f, wy = 0.f, wyy = 0.f;
    if (r < r1) {
      const int nd = node[r];
      in = nd >= lo && nd < lo + tile_S;
      if (in) {
        local = nd - lo;
        const float yr = y[r];
        wv = w[r];
        wy = wv * yr;
        wyy = wy * yr;        // (w*y)*y, the reference's association
      }
    }
    stage[lane] = wv;
    stage[32 + lane] = wy;
    stage[64 + lane] = wyy;
    __syncwarp();
    const unsigned active = __ballot_sync(0xffffffffu, in);
    for (int f = warp; f < F; f += kWarps) {
      if (in) {
        const int idx = local * TB + offsets[f] + (int)binned[r * F + f];
        const unsigned group = __match_any_sync(active, idx);
        if (lane == __ffs(group) - 1) {
          float* b = acc + 3 * idx;
          float a0 = b[0], a1 = b[1], a2 = b[2];
          for (unsigned m = group; m; m &= m - 1) {   // lanes in order
            const int j = __ffs(m) - 1;
            a0 += stage[j];
            a1 += stage[32 + j];
            a2 += stage[64 + j];
          }
          b[0] = a0;
          b[1] = a1;
          b[2] = a2;
        }
      }
      __syncwarp();           // next feature / rows see this bucket update
    }
  }
  __syncthreads();

  float* dst = scratch + (int64_t)blockIdx.x * scratch_stride
               + (int64_t)blockIdx.y * acc_len;
  for (int i = threadIdx.x; i < acc_len; i += blockDim.x) dst[i] = acc[i];
}

__global__ void __launch_bounds__(32 * kReduceLanes)
hist_reduce_kernel(const float* __restrict__ scratch, int G,
                   int64_t scratch_stride, int64_t len,
                   float* __restrict__ out) {
  __shared__ float part[kReduceLanes][33];
  const int64_t e = (int64_t)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < len) {
    for (int g = threadIdx.y; g < G; g += kReduceLanes)
      s += scratch[(int64_t)g * scratch_stride + e];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < len) {
    float t = part[0][threadIdx.x];
    for (int k = 1; k < kReduceLanes; ++k) t += part[k][threadIdx.x];
    out[e] = t;
  }
}

template <typename BinT>
cudaError_t launch_partial(const void* binned, const void* node,
                           const void* w, const void* y, const void* offsets,
                           int64_t n, int F, int TB, int tile_S, int n_tiles,
                           int64_t rows_per_cta, int G,
                           int64_t scratch_stride, void* scratch,
                           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  hist_partial_kernel<BinT><<<dim3(G, n_tiles), kWarps * 32, smem, stream>>>(
      (const BinT*)binned, (const int32_t*)node, (const float*)w,
      (const float*)y, (const int32_t*)offsets, n, F, TB, tile_S,
      rows_per_cta, scratch_stride, (float*)scratch);
  return cudaGetLastError();
}

}  // namespace

// Shared memory pass 1 needs for one block: the accumulator plus each
// warp's 32-row staging of (w, w*y, w*y*y).
extern "C" int64_t hist_gather_smem_bytes(int TB, int tile_S) {
  return (int64_t)tile_S * TB * 3 * 4 + kWarps * 96 * 4;
}

// Launches both passes on `stream`. Returns cudaGetLastError() (0 on
// success). bin_bytes is the element size of `binned` (1 uint8, 2 int16,
// 4 int32). scratch holds G * scratch_stride f32; out holds S*TB*3 f32.
extern "C" int hist_gather_launch(const void* binned, int bin_bytes,
                                  const void* node, const void* w,
                                  const void* y, const void* offsets,
                                  int64_t n, int F, int TB, int S,
                                  int tile_S, int n_tiles,
                                  int64_t rows_per_cta, int G,
                                  void* scratch, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)hist_gather_smem_bytes(TB, tile_S);
  const int64_t stride = (int64_t)n_tiles * tile_S * TB * 3;
  cudaError_t err;
  switch (bin_bytes) {
    case 1:
      err = launch_partial<uint8_t>(binned, node, w, y, offsets, n, F, TB,
                                    tile_S, n_tiles, rows_per_cta, G, stride,
                                    scratch, smem, st);
      break;
    case 2:
      err = launch_partial<int16_t>(binned, node, w, y, offsets, n, F, TB,
                                    tile_S, n_tiles, rows_per_cta, G, stride,
                                    scratch, smem, st);
      break;
    case 4:
      err = launch_partial<int32_t>(binned, node, w, y, offsets, n, F, TB,
                                    tile_S, n_tiles, rows_per_cta, G, stride,
                                    scratch, smem, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t len = (int64_t)S * TB * 3;
  const int blocks = (int)((len + 31) / 32);
  hist_reduce_kernel<<<blocks, dim3(32, kReduceLanes), 0, st>>>(
      (const float*)scratch, G, stride, len, (float*)out);
  return (int)cudaGetLastError();
}
