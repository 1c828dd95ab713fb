// The hash encoding's backward on Hopper (sm_90a): points [P, 3] in [0, 1]
// and the features' gradient [P, L * F] -> the table's gradient
// [entries, F] (fp32), added into a zeroed buffer by atomic adds. Replaces
// no TPU kernel (the JAX package has no hash grid); the plain version is
// ops/encoding.py::hash_encode_backward_plain (index_add_). No gradient goes
// to the positions.
//
// What bounds it: the atomics. A point makes L * 8 * F fp32 adds into rows
// spread over the table (41.9 M row updates a step at the fast recipe's
// 327,680 points, L 16), resolved in the L2; the coarse levels' rows are
// shared by many points of a step and their adds queue at the same
// addresses. The bytes that no version can avoid are the positions and the
// features' gradient read once, 12 + 4 L F bytes a point.
//
// Design: one thread per (point, level), the level fastest (the gradient's
// loads coalesced, as the forward's stores), the same cell, weights and rows
// as the forward (hash_encode_common.cuh), the gradient's row read as one
// float2 (F = 2 only, as the forward), one red.add (atomicAdd whose result
// is unused) per feature of each corner. The order of the adds changes from
// run to run, so the gradient varies in its last bits; the tests hold it to
// a stated tolerance. Capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "hash_encode_common.cuh"

using hash_grid::Levels;

__global__ void __launch_bounds__(hash_grid::THREADS)
hash_encode_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ grad,
                       float* __restrict__ grad_table, long long n,
                       const __grid_constant__ Levels lv) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * lv.count) return;
  const int l = (int)(t % lv.count);
  const long long p = t / lv.count;
  const float2 g = __ldg(grad + t);  // row p * L + l
  const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
  unsigned cell[3];
  float frac[3];
  hash_grid::locate(pt, lv.res[l], cell, frac);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(c, frac);
    float* row = grad_table + hash_grid::corner_entry(lv, l, c, cell) * 2;
    atomicAdd(row, __fmul_rn(w, g.x));
    atomicAdd(row + 1, __fmul_rn(w, g.y));
  }
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (as hash_encode_fwd). grad_table must hold
// zeros (or the sum to add to) on entry.
extern "C" int hash_encode_bwd(const void* x, const void* grad, void* grad_table, long long n,
                               int features, int levels, const int* res, const int* dense,
                               const unsigned* mask, const long long* offset, void* stream) {
  Levels lv;
  if (n < 1 || features != 2 ||
      !hash_grid::make_levels(lv, levels, res, dense, mask, offset))
    return -1;
  const long long blocks = (n * levels + hash_grid::THREADS - 1) / hash_grid::THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  hash_encode_bwd_kernel<<<(unsigned)blocks, hash_grid::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(grad),
      static_cast<float*>(grad_table), n, lv);
  return (int)cudaGetLastError();
}
