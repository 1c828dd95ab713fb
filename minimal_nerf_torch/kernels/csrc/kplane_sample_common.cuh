// K-Planes' multi-scale plane lookup (Fridovich-Keil et al., K-Planes:
// Explicit Radiance Fields in Space, Time, and Appearance, CVPR 2023,
// sec. 3-4; the authors' interpolate_ms_features for a static scene),
// shared by kplane_sample_fwd.cu (the features) and kplane_sample_bwd.cu
// (the scatter-add into the planes' gradients), so that both walk the same
// corners with the same weights.
//
// The planes, channel-last: per scale s a tensor [3, N_s, N_s, 32]; plane c
// spans the axes (w, h) = (0, 1), (0, 2), (1, 2) (row h, column w), the
// pairs of itertools.combinations(range(3), 2). A point of the box
// [lo, hi]^3 takes its cell and place on each axis at N_s, and each plane
// its 4 bilinear weights, from plane_corners.cuh (shared with TensoRF's
// kernels), with no FMA; a point outside the box reads the border
// (grid_sample's padding_mode='border'). Scale s's feature is the product of
// the three planes' interpolated values, channel by channel, in the plane
// order (P_0 * P_1) * P_2; the field's 128 features are the 4 scales' 32 in
// order.
//
// A warp's 32 lanes are the 4 scales x 8 groups of 4 channels (one float4
// of a row): lane l reads scale l / 8, channels 4 (l % 8) .. + 3, so that a
// warp reads each corner row of a scale as 128 contiguous bytes and writes
// (or reads the gradient of) a point's 128 features as 512.
//
// No TPU kernel stands behind these: the JAX package has no K-Planes.

#pragma once

#include <cuda_runtime.h>

#include "plane_corners.cuh"

namespace kplane_sample {

using plane_corners::add4;
using plane_corners::ld4;
using plane_corners::mul4;
using plane_corners::scale4;

constexpr int THREADS = 256;
constexpr int SCALES = 4;
constexpr int C = 32;               // features a plane
constexpr int FEATS = SCALES * C;   // 128 features a point

struct Planes {
  const float* p[SCALES];  // scale s's planes [3, N_s, N_s, C]
  int res[SCALES];         // N_s
  float lo, inv;
};

// the axes of plane c as arithmetic, which folds to constants where the
// caller unrolls c
__device__ __forceinline__ int plane_w(int c) { return c == 2 ? 1 : 0; }
__device__ __forceinline__ int plane_h(int c) { return c == 0 ? 1 : 2; }

// A point's corners on one scale: per plane the first corner's row as an
// index into [3, N, N] rows and its 4 bilinear weights.
struct Corners {
  long long row[3];
  float w[3][4];
};

__device__ __forceinline__ Corners corners(const float p[3], float lo, float inv, int res) {
  int cell[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) plane_corners::locate_axis(p[a], lo, inv, res, cell[a], frac[a]);
  Corners k;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    k.row[c] = ((long long)c * res + cell[plane_h(c)]) * res + cell[plane_w(c)];
    plane_corners::bilinear(frac[plane_w(c)], frac[plane_h(c)], k.w[c]);
  }
  return k;
}

// Plane c's interpolated channels off .. off + 3 at the corners k.
__device__ __forceinline__ float4 value(const float* __restrict__ planes, const Corners& k,
                                        int c, int res, int off) {
  return plane_corners::interpolate4(planes + k.row[c] * C + off, C, res, k.w[c]);
}

}  // namespace kplane_sample
