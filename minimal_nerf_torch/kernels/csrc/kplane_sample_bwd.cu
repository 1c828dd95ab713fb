// K-Planes' multi-scale plane sampling, backward, on Hopper (sm_90a):
// points [P, 3], the 4 scales' planes (fp32, channel-last) and the
// features' gradient [P, 128] -> the planes' gradients, added into buffers
// that hold zeros (or the sums to add to). Replaces no TPU kernel (the JAX
// package has no K-Planes); the plain version is
// kernels/kplane_sample.py::backward_plain (index_add_). No gradient goes
// to the positions.
//
// What bounds it: the adds into the planes' gradients, which the L2
// resolves at a rate of operations, whatever their width (the hash grid's
// backward, hash_encode_bwd.cu, measured it). Scale s's feature is
// P_0 P_1 P_2 channel by channel, so plane c's corner gets w x g x (the
// other two planes' interpolated values): the backward gathers the
// forward's 1,536 floats a point again, then adds 1,536 (384 as float4
// adds), 503 M scalar adds a step at the fast recipe's 327,680 points, fewer
// where consecutive points share a cell and add their rows once. The 64^2
// scale's 4,096 cells a plane take every point's adds, the most contended
// targets. The bytes that no version can avoid are the positions and the
// features' gradient read once, 12 + 4 x 128 = 524 bytes a point.
//
// Design: a warp walks K consecutive points, its lanes the 4 scales x 8
// groups of 4 channels (kplane_sample_common.cuh), so that it reads a
// point's 512-byte gradient row at once and each corner row of a scale as
// 128 contiguous bytes. Per point a lane interpolates its channels of the 3
// planes, forms the 3 co-factors, and keeps one open run per plane: while
// the next point falls in the same cell of that plane, its 4 corner terms
// are summed into the run in registers; a change of cell, or the chunk's
// end, issues the run's 4 float4 adds (atomicAdd(float4*), sm_90). The fine
// pass's points are the sorted samples of each ray, so consecutive points
// often share a cell at 64^2 and 128^2, rarely at 512^2. The sums stay
// fp32; only the order of the adds changes, as it already does from run to
// run, so the gradients vary in their last bits and the tests hold them to
// a stated tolerance. One launch per backward, no allocation, no shared
// memory: capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "kplane_sample_common.cuh"

namespace kp = kplane_sample;

namespace {

constexpr int K = 16;                        // points a warp walks
constexpr int WARPS = kp::THREADS / 32;      // chunks a block

struct Grads {
  const float* g;           // [P, 128]
  float* d[kp::SCALES];     // scale s's gradient [3, N_s, N_s, C]
};

__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void flush(float* grad, long long row, int res, int off,
                                      const float4 acc[4]) {
  float* r = grad + row * kp::C + off;
  red4(r, acc[0]);
  red4(r + kp::C, acc[1]);
  red4(r + (long long)res * kp::C, acc[2]);
  red4(r + (long long)res * kp::C + kp::C, acc[3]);
}

}  // namespace

__global__ void __launch_bounds__(kp::THREADS)
kplane_sample_bwd_kernel(const float* __restrict__ x, long long n,
                         const __grid_constant__ kp::Planes planes,
                         const __grid_constant__ Grads gr) {
  const long long p0 = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * K;
  if (p0 >= n) return;
  const int lane = threadIdx.x & 31, s = lane >> 3, off = 4 * (lane & 7);
  const int res = planes.res[s];
  const float* plane = planes.p[s];
  float* grad = gr.d[s];
  long long run[3] = {-1, -1, -1};  // the open runs' first rows
  float4 acc[3][4];
  const long long end = p0 + K < n ? p0 + K : n;
  for (long long p = p0; p < end; ++p) {
    const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
    const kp::Corners k = kp::corners(pt, planes.lo, planes.inv, res);
    const float4 g = kp::ld4(gr.g + p * kp::FEATS + s * kp::C + off);
    const float4 v0 = kp::value(plane, k, 0, res, off);
    const float4 v1 = kp::value(plane, k, 1, res, off);
    const float4 v2 = kp::value(plane, k, 2, res, off);
    const float4 t[3] = {kp::mul4(g, kp::mul4(v1, v2)), kp::mul4(g, kp::mul4(v0, v2)),
                         kp::mul4(g, kp::mul4(v0, v1))};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (k.row[c] != run[c]) {
        if (run[c] >= 0) flush(grad, run[c], res, off, acc[c]);
        run[c] = k.row[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = kp::scale4(t[c], k.w[c][i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = kp::add4(acc[c][i], kp::scale4(t[c], k.w[c][i]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) flush(grad, run[c], res, off, acc[c]);
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (a resolution under 2; more than
// 2^31 - 1 blocks). The gradient buffers must hold zeros (or the sums to
// add to) on entry.
extern "C" int kplane_sample_bwd(const void* x, long long n, const void* p0, const void* p1,
                                 const void* p2, const void* p3, int r0, int r1, int r2, int r3,
                                 float lo, float inv, const void* g, void* d0, void* d1, void* d2,
                                 void* d3, void* stream) {
  if (n < 1 || r0 < 2 || r1 < 2 || r2 < 2 || r3 < 2) return -1;
  const kp::Planes planes{{static_cast<const float*>(p0), static_cast<const float*>(p1),
                           static_cast<const float*>(p2), static_cast<const float*>(p3)},
                          {r0, r1, r2, r3}, lo, inv};
  const Grads gr{static_cast<const float*>(g),
                 {static_cast<float*>(d0), static_cast<float*>(d1), static_cast<float*>(d2),
                  static_cast<float*>(d3)}};
  const long long blocks = (n + (long long)WARPS * K - 1) / ((long long)WARPS * K);
  if (blocks > 0x7fffffffLL) return -1;
  kplane_sample_bwd_kernel<<<(unsigned)blocks, kp::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                                 n, planes, gr);
  return (int)cudaGetLastError();
}
