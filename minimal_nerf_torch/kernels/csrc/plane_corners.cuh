// The box mapping and the bilinear corner arithmetic of a feature plane
// sampled as grid_sample samples it (bilinear, align_corners=True, the
// coordinate clamped to the border), shared by TensoRF's VM kernels
// (vm_sample_common.cuh) and K-Planes' plane kernels
// (kplane_sample_common.cuh), so that both walk the same cells with the
// same weights.
//
// A point's coordinate p on an axis of the box [lo, hi] maps to
// xhat = (p - lo) * inv - 1 (inv = 2 / (hi - lo)) and to the pixel
// ((xhat + 1) * 0.5) * (N - 1), clamped to [0, N - 1]; its cell is
// floor(pixel) clamped to N - 2, its place pixel - cell. A plane's rows are
// indexed (h, w), the 4 corners taken in the order (h, w), (h, w + 1),
// (h + 1, w), (h + 1, w + 1). Every multiply and add is an explicit
// __fmul_rn / __fadd_rn / __fsub_rn, so that nvcc contracts none of them
// into an FMA: the values are those of the plain PyTorch versions
// (kernels/vm_sample.py::locate, kernels/kplane_sample.py), operation by
// operation.

#pragma once

#include <cuda_runtime.h>

namespace plane_corners {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// The cell and the place in it of the coordinate p on an axis of N cells.
__device__ __forceinline__ void locate_axis(float p, float lo, float inv, int res, int& cell,
                                            float& frac) {
  const float last = (float)(res - 1), top = (float)(res - 2);
  const float xhat = __fsub_rn(mul(__fsub_rn(p, lo), inv), 1.0f);
  const float pix = fminf(fmaxf(mul(mul(add(xhat, 1.0f), 0.5f), last), 0.0f), last);
  const float c = fminf(floorf(pix), top);
  cell = (int)c;
  frac = __fsub_rn(pix, c);
}

// The 4 bilinear weights of places fw (along w) and fh (along h), in the
// corners' order.
__device__ __forceinline__ void bilinear(float fw, float fh, float w[4]) {
  const float ow = __fsub_rn(1.0f, fw), oh = __fsub_rn(1.0f, fh);
  w[0] = mul(ow, oh);
  w[1] = mul(fw, oh);
  w[2] = mul(ow, fh);
  w[3] = mul(fw, fh);
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

// The 4 channels at row + 0 of a channel-last plane of R channels a row,
// N rows a line of the plane, interpolated from the 4 corners whose first
// corner's row starts at row: sum_i corner_i * w_i in the corners' order.
__device__ __forceinline__ float4 interpolate4(const float* __restrict__ row, int R, int res,
                                               const float w[4]) {
  float4 v = scale4(ld4(row), w[0]);
  v = add4(v, scale4(ld4(row + R), w[1]));
  v = add4(v, scale4(ld4(row + (long long)res * R), w[2]));
  return add4(v, scale4(ld4(row + (long long)res * R + R), w[3]));
}

}  // namespace plane_corners
