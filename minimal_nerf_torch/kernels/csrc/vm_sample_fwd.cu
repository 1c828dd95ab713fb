// TensoRF's VM factor sampling, forward, on Hopper (sm_90a): points
// [P, 3] and the density and appearance factors (fp32, channel-last) ->
// f_sigma [P], the sum over 3 modes and 16 density channels of plane x line,
// and the 144 appearance products [P, 144], mode-major (or f_sigma alone).
// Replaces no TPU kernel (the JAX package has no TensoRF); it is TensoRF's
// compute_densityfeature and compute_appfeature (TensorVMSplit, before the
// basis matrix) for the port's tensorf field (models/tensorf.py), whose
// plain version is kernels/vm_sample.py::sample_plain.
//
// What bounds it: the gathers. A point reads 3 modes x (4 plane rows + 2 line
// rows) x 64 channels, 1,152 floats (4.6 KB), from factors of 69.5 MB at
// N = 300, about the size of the 50 MB L2; neighbouring points share rows,
// so most reads hit L2. The bytes that no version can avoid are the position
// read and the outputs written once, 12 + 4 (1 + 144) = 592 bytes a point.
//
// Design: one thread per (point, group of 4 channels), 16 threads a point
// (groups 0-3 density, 4-15 appearance), so that the 16 threads of a point
// read each corner row as 64 + 192 contiguous bytes (float4 loads through
// the read-only path) and the appearance threads store a mode's 48 products
// as 192 contiguous bytes. Per mode a thread interpolates its 4 channels of
// the plane and the line (vm_sample_common.cuh) and multiplies them; a
// density thread sums its 4 products in channel order and the modes in
// order, and the 4 density threads of a point add their sums pairwise by
// shuffles ((g0 + g1) + (g2 + g3)), as the plain version does. A point
// outside the box writes -inf (density 0 after softplus) and zero products.
// vm_sample_fwd_kernel<false> (f_sigma alone, the grid's update) runs the
// density threads only. No shared memory; capturable in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

#include "vm_sample_common.cuh"

namespace vm = vm_sample;

template <bool kApp>
__global__ void __launch_bounds__(vm::THREADS)
vm_sample_fwd_kernel(const float* __restrict__ x, long long n, const __grid_constant__ vm::Factors f,
                     float* __restrict__ sigma, float* __restrict__ prods) {
  constexpr int G = kApp ? vm::GROUPS : vm::DENSITY_GROUPS;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t / G;
  const int g = (int)(t % G);
  if (p >= n) return;  // a point's G threads (G divides 32) share a warp and this test
  const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
  const bool density = g < vm::DENSITY_GROUPS;
  if (!vm::inside(pt, f)) {
    if (g == 0) sigma[p] = -INFINITY;
    if (kApp && !density) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        *reinterpret_cast<float4*>(prods + p * vm::PROD + m * vm::RC + 4 * (g - 4)) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  int cell[3];
  float frac[3];
  vm::locate(pt, f, cell, frac);
  const float* plane = density ? f.dp : f.ap;
  const float* line = density ? f.dl : f.al;
  const int R = density ? vm::RD : vm::RC, c = density ? 4 * g : 4 * (g - 4);
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const vm::Corners k = vm::corners(m, cell, frac, f.res);
    float4 pv, lv;
    vm::values(plane, line, R, c, k, f.res, pv, lv);
    const float4 pr = vm::mul4(pv, lv);
    if (density) {
      const float s = vm::add(vm::add(vm::add(pr.x, pr.y), pr.z), pr.w);
      acc = m == 0 ? s : vm::add(acc, s);
    } else if (kApp) {
      *reinterpret_cast<float4*>(prods + p * vm::PROD + m * vm::RC + c) = pr;
    }
  }
  if (density) {
    // the point's 4 density threads: lanes base .. base + 3 of the warp
    const unsigned lane = threadIdx.x & 31u;
    const unsigned mask = 0xfu << (lane & ~3u);
    acc = vm::add(acc, __shfl_xor_sync(mask, acc, 1));
    acc = vm::add(acc, __shfl_xor_sync(mask, acc, 2));
    if (g == 0) sigma[p] = acc;
  }
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (N < 2; more than 2^31 - 1 blocks). With
// prods null only f_sigma is computed (ap and al are not read).
extern "C" int vm_sample_fwd(const void* x, long long n, const void* dp, const void* dl,
                             const void* ap, const void* al, int res, float lo, float hi,
                             float inv, void* sigma, void* prods, void* stream) {
  if (n < 1 || res < 2) return -1;
  const vm::Factors f{static_cast<const float*>(dp), static_cast<const float*>(dl),
                      static_cast<const float*>(ap), static_cast<const float*>(al), res, lo,
                      hi, inv};
  const int groups = prods != nullptr ? vm::GROUPS : vm::DENSITY_GROUPS;
  const long long blocks = (n * groups + vm::THREADS - 1) / vm::THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<float*>(sigma);
  if (prods != nullptr)
    vm_sample_fwd_kernel<true><<<(unsigned)blocks, vm::THREADS, 0, s>>>(
        xp, n, f, sp, static_cast<float*>(prods));
  else
    vm_sample_fwd_kernel<false><<<(unsigned)blocks, vm::THREADS, 0, s>>>(xp, n, f, sp, nullptr);
  return (int)cudaGetLastError();
}
