// The hash encoding's backward on Hopper (sm_90a): points [P, 3] in [0, 1]
// and the features' gradient [P, L * F] -> the table's gradient
// [entries, F] (fp32), added into a buffer that holds zeros or the sum to add
// to. Replaces no TPU kernel (the JAX package has no hash grid); the plain
// version is ops/encoding.py::hash_encode_backward_plain (index_add_). No
// gradient goes to the positions.
//
// What bounds it: the adds into the table's gradient, which the L2 resolves
// at a rate of operations (about 60-70 G a second on an H100, whether an add
// moves 4 or 8 bytes). A point makes L * 8 row updates of F = 2 floats
// (41.9 M a step at the fast recipe's 327,680 points, L 16): as scalar adds
// 84 M operations, as float2 adds half that, and fewer still where
// neighbouring points share a row and add it once. Lanes on different levels
// never share a row, so the lanes that merge must be on one level. The bytes
// that no version can avoid are the positions and the features' gradient
// read once, 12 + 4 L F bytes a point.
//
// Design: level-major warps that merge equal rows in registers.
// - A block takes TILE consecutive points and LEVEL_GROUP levels (blockIdx.y
//   picks the group; the card issues blocks in index order, so the blocks in
//   flight add into about four levels' rows, 16 MB of the 98 MB gradient,
//   which stay in the L2). It stages the tile's positions and its levels'
//   gradient rows in shared memory with coalesced loads (each point's row
//   padded to LEVEL_GROUP + 1 float2, so that lanes reading one level hit
//   distinct banks); each byte of the gradient is read by one block.
// - Each warp walks (level, 32 consecutive points) items: its lanes are
//   consecutive points on one level, with the cell, weights and rows of the
//   forward (hash_encode_common.cuh).
// - A run is a stretch of adjacent lanes in one cell, so each of its 8 corner
//   rows is one row for the whole run. A segmented shuffle scan sums each
//   corner's (w g.x, w g.y) over the run, and the run's last lane issues one
//   float2 red (red.global.add.v2.f32) per corner. A warp whose lanes all sit
//   in distinct cells skips the scan. The fine pass's points are the sorted
//   samples of each ray, so runs are long on the coarse levels and still
//   present on the finest (train.ngp: 77% of the updates merged on level 0,
//   7% on level 15); for points in any other order nothing merges and the
//   merge costs three shuffles and a ballot per item.
// - hash_encode_bwd_counted_kernel, the same body with kCounted, adds the
//   reds each block issued, per level, to a device counter (the tests and the
//   smoke read it); the main path launches hash_encode_bwd_kernel.
// The sums stay fp32; only the order of the adds changes, as it already does
// from run to run, so the gradient varies in its last bits and the tests hold
// it to a stated tolerance. One launch per backward, no allocation:
// capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "hash_encode_common.cuh"

using hash_grid::Levels;

namespace {

constexpr int TILE = 64;         // points a block
constexpr int LEVEL_GROUP = 4;   // levels a block (blockIdx.y picks the group)
constexpr int WARPS = hash_grid::THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <bool kCounted>
__device__ __forceinline__ void backward_tile(const float* __restrict__ x,
                                              const float2* __restrict__ grad,
                                              float2* __restrict__ grad_table, long long n,
                                              const Levels& lv,
                                              unsigned long long* __restrict__ reds) {
  __shared__ float2 sg[TILE * (LEVEL_GROUP + 1)];
  __shared__ float sx[TILE * 3];
  __shared__ unsigned issued[LEVEL_GROUP];
  const int l0 = blockIdx.y * LEVEL_GROUP, levels = min(LEVEL_GROUP, lv.count - l0);
  const long long p0 = (long long)blockIdx.x * TILE;
  const int m = (int)min((long long)TILE, n - p0);
  for (int i = threadIdx.x; i < m * levels; i += blockDim.x) {
    const int j = i / levels, k = i - j * levels;
    sg[j * (LEVEL_GROUP + 1) + k] = __ldg(grad + (p0 + j) * lv.count + l0 + k);
  }
  for (int i = threadIdx.x; i < m * 3; i += blockDim.x) sx[i] = __ldg(x + 3 * p0 + i);
  if (kCounted && threadIdx.x < levels) issued[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, groups = (m + 31) / 32;
  for (int item = threadIdx.x >> 5; item < levels * groups; item += WARPS) {
    const int k = item / groups, l = l0 + k, j = (item % groups) * 32 + lane;
    const bool valid = j < m;
    float2 g = make_float2(0.0f, 0.0f);
    unsigned cell[3] = {0u, 0u, 0u};
    float frac[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      g = sg[j * (LEVEL_GROUP + 1) + k];
      const float pt[3] = {sx[3 * j], sx[3 * j + 1], sx[3 * j + 2]};
      hash_grid::locate(pt, lv.res[l], cell, frac);
    }
    // a run starts where the cell changes; lanes past the tile's end start
    // runs of their own and issue nothing
    const unsigned up0 = __shfl_up_sync(FULL, cell[0], 1);
    const unsigned up1 = __shfl_up_sync(FULL, cell[1], 1);
    const unsigned up2 = __shfl_up_sync(FULL, cell[2], 1);
    const bool head = !valid || lane == 0 || up0 != cell[0] || up1 != cell[1] || up2 != cell[2];
    const unsigned heads = __ballot_sync(FULL, head);
    const bool last = valid && (lane == 31 || ((heads >> (lane + 1)) & 1u));
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = hash_grid::corner_weight(c, frac);
      v[c] = make_float2(__fmul_rn(w, g.x), __fmul_rn(w, g.y));
    }
    if (heads != FULL) {  // warp-uniform: some run is longer than one lane
      const int start = 31 - __clz(heads & (FULL >> (31 - lane)));
      const unsigned span = __reduce_max_sync(FULL, (unsigned)(lane - start + 1));
      for (unsigned off = 1; off < span; off <<= 1) {
        const bool take = lane - (int)off >= start;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float ax = __shfl_up_sync(FULL, v[c].x, off);
          const float ay = __shfl_up_sync(FULL, v[c].y, off);
          if (take) {
            v[c].x = __fadd_rn(v[c].x, ax);
            v[c].y = __fadd_rn(v[c].y, ay);
          }
        }
      }
    }
    if (last) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        atomicAdd(grad_table + hash_grid::corner_entry(lv, l, c, cell), v[c]);
    }
    if (kCounted) {
      const unsigned lasts = __ballot_sync(FULL, last);
      if (lane == 0) atomicAdd(&issued[k], 8u * (unsigned)__popc(lasts));
    }
  }
  if (kCounted) {
    __syncthreads();
    if (threadIdx.x < levels)
      atomicAdd(reds + l0 + threadIdx.x, (unsigned long long)issued[threadIdx.x]);
  }
}

}  // namespace

__global__ void __launch_bounds__(hash_grid::THREADS)
hash_encode_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ grad,
                       float2* __restrict__ grad_table, long long n,
                       const __grid_constant__ Levels lv) {
  backward_tile<false>(x, grad, grad_table, n, lv, nullptr);
}

__global__ void __launch_bounds__(hash_grid::THREADS)
hash_encode_bwd_counted_kernel(const float* __restrict__ x, const float2* __restrict__ grad,
                               float2* __restrict__ grad_table, long long n,
                               const __grid_constant__ Levels lv,
                               unsigned long long* __restrict__ reds) {
  backward_tile<true>(x, grad, grad_table, n, lv, reds);
}

namespace {

int launch(const void* x, const void* grad, void* grad_table, long long n, int features,
           int levels, const int* res, const int* dense, const unsigned* mask,
           const long long* offset, void* stream, unsigned long long* reds) {
  Levels lv;
  if (n < 1 || features != 2 ||
      !hash_grid::make_levels(lv, levels, res, dense, mask, offset))
    return -1;
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return -1;
  const dim3 blocks((unsigned)tiles, (unsigned)((levels + LEVEL_GROUP - 1) / LEVEL_GROUP));
  const auto* xp = static_cast<const float*>(x);
  const auto* gp = static_cast<const float2*>(grad);
  auto* tp = static_cast<float2*>(grad_table);
  const auto s = static_cast<cudaStream_t>(stream);
  if (reds == nullptr)
    hash_encode_bwd_kernel<<<blocks, hash_grid::THREADS, 0, s>>>(xp, gp, tp, n, lv);
  else
    hash_encode_bwd_counted_kernel<<<blocks, hash_grid::THREADS, 0, s>>>(xp, gp, tp, n, lv,
                                                                         reds);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (as hash_encode_fwd). grad_table must hold
// zeros (or the sum to add to) on entry.
extern "C" int hash_encode_bwd(const void* x, const void* grad, void* grad_table, long long n,
                               int features, int levels, const int* res, const int* dense,
                               const unsigned* mask, const long long* offset, void* stream) {
  return launch(x, grad, grad_table, n, features, levels, res, dense, mask, offset, stream,
                nullptr);
}

// hash_encode_bwd, also adding to reds[l] (L uint64, on the device) the
// float2 reds issued on level l, 8 per run of lanes.
extern "C" int hash_encode_bwd_counted(const void* x, const void* grad, void* grad_table,
                                       long long n, int features, int levels, const int* res,
                                       const int* dense, const unsigned* mask,
                                       const long long* offset, void* stream, void* reds) {
  return launch(x, grad, grad_table, n, features, levels, res, dense, mask, offset, stream,
                static_cast<unsigned long long*>(reds));
}
