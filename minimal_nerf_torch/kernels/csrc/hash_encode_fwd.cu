// The hash encoding's forward on Hopper (sm_90a): points [P, 3] in [0, 1]
// and the table [entries, F] (fp32) -> features [P, L * F] (fp32),
// level-major. Replaces no TPU kernel (the JAX package has no hash grid); it
// is Instant-NGP's encoding (sec. 3) for the port's ngp field
// (models/ngp.py), whose plain version is ops/encoding.py::hash_encode_plain.
//
// What bounds it: latency of the gathers. A point makes L * 8 gathers of F
// floats from rows spread over a 48.8 MB table at the published sizes (L 16,
// F 2, T 2^19): about the size of the 50 MB L2, so the coarse levels' rows
// stay in L2 and the finest levels' miss to HBM now and then. The bytes that
// no version can avoid are the positions read and the features written,
// 12 + 4 L F bytes a point (140 at the published sizes).
//
// Design: one thread per (point, level), the level fastest, so that a warp's
// 32 features land in 256 contiguous bytes (coalesced stores) and the 16
// threads of a point share one read of its position. Each thread finds its
// cell, walks the 8 corners in order c = 0 .. 7 and sums weight * row as the
// plain version does (explicit round-to-nearest multiplies and adds: no FMA),
// reading each row as one float2 through the read-only path (F = 2, the
// paper's, is the only width built). No shared memory, no synchronisation;
// capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "hash_encode_common.cuh"

using hash_grid::Levels;

__global__ void __launch_bounds__(hash_grid::THREADS)
hash_encode_fwd_kernel(const float* __restrict__ x, const float2* __restrict__ table,
                       float2* __restrict__ out, long long n,
                       const __grid_constant__ Levels lv) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * lv.count) return;
  const int l = (int)(t % lv.count);
  const long long p = t / lv.count;
  const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
  unsigned cell[3];
  float frac[3];
  hash_grid::locate(pt, lv.res[l], cell, frac);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(c, frac);
    const float2 v = __ldg(table + hash_grid::corner_entry(lv, l, c, cell));
    a0 = __fadd_rn(a0, __fmul_rn(w, v.x));
    a1 = __fadd_rn(a1, __fmul_rn(w, v.y));
  }
  out[t] = make_float2(a0, a1);  // row p * L + l
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (F other than 2; more than 32 levels; more
// than 2^31 - 1 blocks).
extern "C" int hash_encode_fwd(const void* x, const void* table, void* out, long long n,
                               int features, int levels, const int* res, const int* dense,
                               const unsigned* mask, const long long* offset, void* stream) {
  Levels lv;
  if (n < 1 || features != 2 ||
      !hash_grid::make_levels(lv, levels, res, dense, mask, offset))
    return -1;
  const long long blocks = (n * levels + hash_grid::THREADS - 1) / hash_grid::THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  hash_encode_fwd_kernel<<<(unsigned)blocks, hash_grid::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(table),
      static_cast<float2*>(out), n, lv);
  return (int)cudaGetLastError();
}
