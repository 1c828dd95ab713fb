// TensoRF's VM factor sampling, backward, on Hopper (sm_90a): points [P, 3],
// the factors (fp32, channel-last) and the gradients of f_sigma [P] and of
// the appearance products [P, 144] -> the four factors' gradients, added
// into buffers that hold zeros (or the sums to add to). Replaces no TPU
// kernel (the JAX package has no TensoRF); the plain version is
// kernels/vm_sample.py::backward_plain (index_add_). No gradient goes to the
// positions, and none comes from a point outside the box.
//
// What bounds it: the adds into the factors' gradients, which the L2
// resolves at a rate of operations, whatever their width (the hash grid's
// backward, hash_encode_bwd.cu, measured it). A point updates 3 modes x
// (4 plane rows + 2 line rows) x 64 channels, 1,152 floats: as scalar adds
// 377 M operations a step at the fast recipe's 327,680 points, as float4
// adds a quarter of that, and fewer again where consecutive points share a
// cell and add their rows once. The gradient of a plane row's channel is
// g x w x (the line's value), of a line row's g x w x (the plane's value),
// so the backward gathers the forward's rows again. The bytes that no
// version can avoid are the positions and the two gradients read once,
// 12 + 4 (1 + 144) = 592 bytes a point.
//
// Design: each thread walks K consecutive points for one group of 4
// channels of one mode (blockIdx.y), 16 groups side by side, so that a
// warp's 16 groups of a point read and add whole 64 + 192-byte rows; a
// block holds 16 such chunks of K points. Along its chunk a thread keeps one
// open run for the plane and one for the line: while the next point falls
// in the same plane cell (or line cell) its 4 (or 2) corner terms are
// summed into the run in registers; a change of cell, or the chunk's end,
// issues the run's float4 adds (atomicAdd(float4*), sm_90), one per corner.
// The fine pass's points are the sorted samples of each ray, so
// consecutive points often share a cell of the 300^2 planes and more often
// one of the 300-cell lines. The sums stay fp32; only the order of the adds
// changes, as it already does from run to run, so the gradients vary in
// their last bits and the tests hold them to a stated tolerance. One launch
// per backward, no allocation, no shared memory: capturable in a CUDA graph.

#include <cuda_runtime.h>

#include "vm_sample_common.cuh"

namespace vm = vm_sample;

namespace {

constexpr int K = 16;                      // points a thread walks
constexpr int CHUNKS = vm::THREADS / 16;   // chunks a block

struct Grads {
  const float* g_sigma;  // [P]
  const float* g_prods;  // [P, 144]
  float* dp;
  float* dl;
  float* ap;
  float* al;
};

__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

template <int M>
__device__ __forceinline__ void walk(const float* __restrict__ x, long long p0, long long n,
                                     const vm::Factors& f, const Grads& gr, int g) {
  const bool density = g < vm::DENSITY_GROUPS;
  const float* plane = density ? f.dp : f.ap;
  const float* line = density ? f.dl : f.al;
  float* gplane = density ? gr.dp : gr.ap;
  float* gline = density ? gr.dl : gr.al;
  const int R = density ? vm::RD : vm::RC, c = density ? 4 * g : 4 * (g - 4);
  const long long res = f.res;
  long long prun = -1, lrun = -1;  // the open runs' first rows
  float4 pacc[4], lacc[2];
  const long long end = p0 + K < n ? p0 + K : n;
  for (long long p = p0; p < end; ++p) {
    const float pt[3] = {__ldg(x + 3 * p), __ldg(x + 3 * p + 1), __ldg(x + 3 * p + 2)};
    if (!vm::inside(pt, f)) continue;
    int cell[3];
    float frac[3];
    vm::locate(pt, f, cell, frac);
    const vm::Corners k = vm::corners(M, cell, frac, f.res);
    float4 gv;
    if (density) {
      const float s = __ldg(gr.g_sigma + p);
      gv = make_float4(s, s, s, s);
    } else {
      gv = vm::ld4(gr.g_prods + p * vm::PROD + M * vm::RC + c);
    }
    float4 pv, lv;
    vm::values(plane, line, R, c, k, f.res, pv, lv);
    const float4 tp = vm::mul4(gv, lv), tl = vm::mul4(gv, pv);
    if (k.prow != prun) {
      if (prun >= 0) {
        float* row = gplane + prun * R + c;
        red4(row, pacc[0]);
        red4(row + R, pacc[1]);
        red4(row + res * R, pacc[2]);
        red4(row + res * R + R, pacc[3]);
      }
      prun = k.prow;
#pragma unroll
      for (int i = 0; i < 4; ++i) pacc[i] = vm::scale4(tp, k.pw[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) pacc[i] = vm::add4(pacc[i], vm::scale4(tp, k.pw[i]));
    }
    if (k.lrow != lrun) {
      if (lrun >= 0) {
        float* row = gline + lrun * R + c;
        red4(row, lacc[0]);
        red4(row + R, lacc[1]);
      }
      lrun = k.lrow;
#pragma unroll
      for (int i = 0; i < 2; ++i) lacc[i] = vm::scale4(tl, k.lw[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) lacc[i] = vm::add4(lacc[i], vm::scale4(tl, k.lw[i]));
    }
  }
  if (prun >= 0) {
    float* row = gplane + prun * R + c;
    red4(row, pacc[0]);
    red4(row + R, pacc[1]);
    red4(row + res * R, pacc[2]);
    red4(row + res * R + R, pacc[3]);
  }
  if (lrun >= 0) {
    float* row = gline + lrun * R + c;
    red4(row, lacc[0]);
    red4(row + R, lacc[1]);
  }
}

}  // namespace

__global__ void __launch_bounds__(vm::THREADS)
vm_sample_bwd_kernel(const float* __restrict__ x, long long n,
                     const __grid_constant__ vm::Factors f, const __grid_constant__ Grads gr) {
  const int g = threadIdx.x & 15;
  const long long p0 = ((long long)blockIdx.x * CHUNKS + (threadIdx.x >> 4)) * K;
  if (p0 >= n) return;
  switch (blockIdx.y) {  // the mode, a constant inside walk so that the axes fold
    case 0: walk<0>(x, p0, n, f, gr, g); break;
    case 1: walk<1>(x, p0, n, f, gr, g); break;
    default: walk<2>(x, p0, n, f, gr, g); break;
  }
}

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take (N < 2; more than 2^31 - 1 blocks). The
// four gradient buffers must hold zeros (or the sums to add to) on entry.
extern "C" int vm_sample_bwd(const void* x, long long n, const void* dp, const void* dl,
                             const void* ap, const void* al, int res, float lo, float hi,
                             float inv, const void* g_sigma, const void* g_prods, void* gdp,
                             void* gdl, void* gap, void* gal, void* stream) {
  if (n < 1 || res < 2) return -1;
  const vm::Factors f{static_cast<const float*>(dp), static_cast<const float*>(dl),
                      static_cast<const float*>(ap), static_cast<const float*>(al), res, lo,
                      hi, inv};
  const Grads gr{static_cast<const float*>(g_sigma), static_cast<const float*>(g_prods),
                 static_cast<float*>(gdp), static_cast<float*>(gdl), static_cast<float*>(gap),
                 static_cast<float*>(gal)};
  const long long blocks = (n + (long long)CHUNKS * K - 1) / ((long long)CHUNKS * K);
  if (blocks > 0x7fffffffLL) return -1;
  vm_sample_bwd_kernel<<<dim3((unsigned)blocks, 3), vm::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x), n,
                                                             f, gr);
  return (int)cudaGetLastError();
}
