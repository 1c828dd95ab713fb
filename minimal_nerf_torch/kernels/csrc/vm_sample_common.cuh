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
// the box [lo, hi]^3 maps to xhat = (x - lo) * inv - 1 and to the pixel
// ((xhat + 1) * 0.5) * (N - 1) per axis, clamped to [0, N - 1]; its cell is
// floor(pixel) clamped to N - 2, its place pixel - cell. Every multiply and
// add is an explicit __fmul_rn / __fadd_rn / __fsub_rn, so that nvcc
// contracts none of them into an FMA: the values are those of the plain
// PyTorch version (kernels/vm_sample.py::sample_plain), operation by
// operation.
//
// Threads work on groups of 4 channels (one float4 of a row): groups 0-3
// are the density's 16 channels, groups 4-15 the appearance's 48.
//
// No TPU kernel stands behind these: the JAX package has no TensoRF.

#pragma once

#include <cuda_runtime.h>

namespace vm_sample {

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

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ bool inside(const float p[3], const Factors& f) {
  return p[0] >= f.lo && p[0] <= f.hi && p[1] >= f.lo && p[1] <= f.hi && p[2] >= f.lo &&
         p[2] <= f.hi;
}

// Each axis's cell and place of a point inside the box.
__device__ __forceinline__ void locate(const float p[3], const Factors& f, int cell[3],
                                       float frac[3]) {
  const float last = (float)(f.res - 1), top = (float)(f.res - 2);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xhat = __fsub_rn(mul(__fsub_rn(p[a], f.lo), f.inv), 1.0f);
    const float pix = fminf(fmaxf(mul(mul(add(xhat, 1.0f), 0.5f), last), 0.0f), last);
    const float c = fminf(floorf(pix), top);
    cell[a] = (int)c;
    frac[a] = __fsub_rn(pix, c);
  }
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
  const float fw = frac[aw], fh = frac[ah], fl = frac[al];
  const float ow = __fsub_rn(1.0f, fw), oh = __fsub_rn(1.0f, fh);
  c.prow = ((long long)m * res + cell[ah]) * res + cell[aw];
  c.lrow = (long long)m * res + cell[al];
  c.pw[0] = mul(ow, oh);
  c.pw[1] = mul(fw, oh);
  c.pw[2] = mul(ow, fh);
  c.pw[3] = mul(fw, fh);
  c.lw[0] = __fsub_rn(1.0f, fl);
  c.lw[1] = fl;
  return c;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(mul(v.x, w), mul(v.y, w), mul(v.z, w), mul(v.w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z), mul(a.w, b.w));
}

// The 4 channels at offset c of R of mode m's interpolated plane (pv) and
// line (lv).
__device__ __forceinline__ void values(const float* __restrict__ plane,
                                       const float* __restrict__ line, int R, int c,
                                       const Corners& k, int res, float4& pv, float4& lv) {
  const float* row = plane + k.prow * R + c;
  pv = scale4(ld4(row), k.pw[0]);
  pv = add4(pv, scale4(ld4(row + R), k.pw[1]));
  pv = add4(pv, scale4(ld4(row + (long long)res * R), k.pw[2]));
  pv = add4(pv, scale4(ld4(row + (long long)res * R + R), k.pw[3]));
  const float* lrow = line + k.lrow * R + c;
  lv = add4(scale4(ld4(lrow), k.lw[0]), scale4(ld4(lrow + R), k.lw[1]));
}

}  // namespace vm_sample
