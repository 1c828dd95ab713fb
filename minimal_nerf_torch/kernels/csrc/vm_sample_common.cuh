// TensoRF's vector-matrix factor lookup (Chen et al., TensoRF: Tensorial
// Radiance Fields, ECCV 2022, sec. 3-4), shared by vm_sample_fwd.cu (the
// interpolated plane and line values and their products) and
// vm_sample_bwd.cu (the scatter-add into the factors' gradients), so that
// both walk the same corners with the same weights.
//
// The factors, channel-last: density planes [3, N, N, 16] and lines
// [3, N, 16], appearance planes [3, N, N, 48] and lines [3, N, 48]. Mode m's
// plane spans the axes (w, h) = (0, 1), (0, 2), (1, 2) (row h, column w),
// its line the axis 2, 1, 0 (TensoRF's matMode and vecMode). A point x of
// the box [lo, hi]^3 takes its cell and place on each axis, and a plane
// its 4 bilinear weights, from plane_corners.cuh (shared with K-Planes'
// kernels), with no FMA: the values are those of the plain PyTorch version
// (kernels/vm_sample.py::sample_plain), operation by operation.
//
// Threads work on groups of 4 channels (one float4 of a row): groups 0-3
// are the density's 16 channels, groups 4-15 the appearance's 48.
//
// No TPU kernel stands behind these: the JAX package has no TensoRF.

#pragma once

#include <cuda_runtime.h>

#include "plane_corners.cuh"

namespace vm_sample {

using plane_corners::add;
using plane_corners::add4;
using plane_corners::ld4;
using plane_corners::mul;
using plane_corners::mul4;
using plane_corners::scale4;

constexpr int THREADS = 256;
constexpr int RD = 16;                  // density components a mode
constexpr int RC = 48;                  // appearance components a mode
constexpr int DENSITY_GROUPS = RD / 4;  // 4
constexpr int GROUPS = (RD + RC) / 4;   // 16
constexpr int PROD = 3 * RC;            // appearance products a point

// the axes of mode m (TensoRF's matMode and vecMode) as arithmetic, which
// folds to constants where the caller unrolls m, so that cell[] and frac[]
// stay in registers
__device__ __forceinline__ int plane_w(int m) { return m == 2 ? 1 : 0; }
__device__ __forceinline__ int plane_h(int m) { return m == 0 ? 1 : 2; }
__device__ __forceinline__ int line_axis(int m) { return 2 - m; }

struct Factors {
  const float* dp;  // density planes [3, N, N, RD]
  const float* dl;  // density lines [3, N, RD]
  const float* ap;  // appearance planes [3, N, N, RC]
  const float* al;  // appearance lines [3, N, RC]
  int res;          // N
  float lo, hi, inv;
};

__device__ __forceinline__ bool inside(const float p[3], const Factors& f) {
  return p[0] >= f.lo && p[0] <= f.hi && p[1] >= f.lo && p[1] <= f.hi && p[2] >= f.lo &&
         p[2] <= f.hi;
}

// Each axis's cell and place of a point inside the box.
__device__ __forceinline__ void locate(const float p[3], const Factors& f, int cell[3],
                                       float frac[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    plane_corners::locate_axis(p[a], f.lo, f.inv, f.res, cell[a], frac[a]);
}

// Mode m's corners: the plane's first row (h, w) as an index into
// [3, N, N] rows, its 4 bilinear weights in the order (h, w), (h, w + 1),
// (h + 1, w), (h + 1, w + 1); the line's first row as an index into
// [3, N] rows, its 2 linear weights.
struct Corners {
  long long prow, lrow;
  float pw[4], lw[2];
};

__device__ __forceinline__ Corners corners(int m, const int cell[3], const float frac[3],
                                           int res) {
  Corners c;
  const int aw = plane_w(m), ah = plane_h(m), al = line_axis(m);
  const float fl = frac[al];
  c.prow = ((long long)m * res + cell[ah]) * res + cell[aw];
  c.lrow = (long long)m * res + cell[al];
  plane_corners::bilinear(frac[aw], frac[ah], c.pw);
  c.lw[0] = __fsub_rn(1.0f, fl);
  c.lw[1] = fl;
  return c;
}

// The 4 channels at offset c of R of mode m's interpolated plane (pv) and
// line (lv).
__device__ __forceinline__ void values(const float* __restrict__ plane,
                                       const float* __restrict__ line, int R, int c,
                                       const Corners& k, int res, float4& pv, float4& lv) {
  pv = plane_corners::interpolate4(plane + k.prow * R + c, R, res, k.pw);
  const float* lrow = line + k.lrow * R + c;
  lv = add4(scale4(ld4(lrow), k.lw[0]), scale4(ld4(lrow + R), k.lw[1]));
}

}  // namespace vm_sample
