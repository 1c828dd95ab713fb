// K-Planes' multi-scale plane sampling, forward, on Hopper (sm_90a): points
// [P, 3] and 4 scales of 3 planes (fp32, channel-last [3, N_s, N_s, 32]) ->
// the features [P, 128], per scale the product of the 3 planes'
// bilinearly interpolated values. Replaces no TPU kernel (the JAX package
// has no K-Planes); it is interpolate_ms_features of the authors'
// KPlaneField for the port's kplanes field (models/kplanes.py), whose plain
// version is kernels/kplane_sample.py::sample_plain.
//
// What bounds it: the gathers. A point reads 4 scales x 3 planes x 4 corner
// rows x 32 channels, 1,536 floats (6.1 KB), from 133.7 MB of planes, more
// than the 50 MB L2 (the 512^2 scale alone holds 100.7 MB); neighbouring
// points share rows, most of all at 64^2, so many reads hit L2. The bytes
// that no version can avoid are the position read and the features written
// once, 12 + 4 x 128 = 524 bytes a point.
//
// Design: one warp per point, a lane per (scale, group of 4 channels)
// (kplane_sample_common.cuh), so that each corner load of the warp is 4
// rows of 128 contiguous bytes (float4 loads through the read-only path)
// and its store the point's 512 contiguous bytes. A lane locates the point
// at its scale's resolution, interpolates its 4 channels of each plane and
// multiplies them, with the plain version's operations in its order. No
// shared memory, no mask: a point outside the box reads the border.
// Capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "kplane_sample_common.cuh"

namespace kp = kplane_sample;

__global__ void __launch_bounds__(kp::THREADS)
kplane_sample_fwd_kernel(const float* __restrict__ x, long long n,
                         const __grid_constant__ kp::Planes planes, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t >> 5;
  if (p >= n) return;  // a point's 32 lanes are one warp and share this test
  const int lane = (int)(t & 31), s = lane >> 3, off = 4 * (lane & 7);
  const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
  const int res = planes.res[s];
  const float* plane = planes.p[s];
  const kp::Corners k = kp::corners(pt, planes.lo, planes.inv, res);
  float4 f = kp::value(plane, k, 0, res, off);
  f = kp::mul4(f, kp::value(plane, k, 1, res, off));
  f = kp::mul4(f, kp::value(plane, k, 2, res, off));
  *reinterpret_cast<float4*>(out + p * kp::FEATS + s * kp::C + off) = f;
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (a resolution under 2; more than
// 2^31 - 1 blocks).
extern "C" int kplane_sample_fwd(const void* x, long long n, const void* p0, const void* p1,
                                 const void* p2, const void* p3, int r0, int r1, int r2, int r3,
                                 float lo, float inv, void* out, void* stream) {
  if (n < 1 || r0 < 2 || r1 < 2 || r2 < 2 || r3 < 2) return -1;
  const kp::Planes planes{{static_cast<const float*>(p0), static_cast<const float*>(p1),
                           static_cast<const float*>(p2), static_cast<const float*>(p3)},
                          {r0, r1, r2, r3}, lo, inv};
  const long long blocks = (n * 32 + kp::THREADS - 1) / kp::THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  kplane_sample_fwd_kernel<<<(unsigned)blocks, kp::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, planes, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
