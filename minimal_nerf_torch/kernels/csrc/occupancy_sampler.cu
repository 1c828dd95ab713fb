// Occupancy-guided coarse sampler for Hopper (sm_90a): the whole coarse
// sampler hook of ops/occupancy.py::make_occupancy_sampler in one launch.
//
// Replaces the Pallas TPU kernel `_probe_kernel` of
// minimal_nerf_tpu/kernels/occupancy_probe.py together with the XLA code
// around it in minimal_nerf_tpu/ops/occupancy.py (`query_bin_weights` and
// `occupancy_coarse_samples`). For each ray (o, d) and its draws eps [1] and,
// with in-bin jitter, frac [S], both U[0, 1):
//   1. the cell of each of the B bin midpoints
//        mid_b = near + (b + 0.5) * width,  pos = o + mid_b * d,
//        v = floor((pos + bound) * scale)  (per axis),
//      inside the grid's box if 0 <= v < G on every axis (the unclamped
//      cell), its linear index (x * G + y) * G + z from the clamped cell;
//   2. the probe of that cell's bit (occupancy_common.cuh);
//   3. the bin weight: 1 if occupied, `floor` if inside, 0 outside;
//   4. uniform weights for a ray with no positive weight;
//   5. the CDF over the bins, normalised by (its last value + 1e-10);
//   6. u_s = s / S + eps / S for s < S;
//   7. idx_s = the count of CDF values below u_s (searchsorted, side left),
//      clamped to B - 1;
//   8. the place in the bin: frac_s with jitter, else the exact CDF inverse
//      clamp((u - lo) / (hi - lo), 0, 1) (hi - lo below 1e-10 divides by 1);
//   9. t_s = near + (idx_s + frac_s) * width;
//  10. with jitter, t sorted ascending;
//  11. samples_s = o + t_s * d.
// Outputs ts [N, S], samples [N, S, 3] and, on request, the weights [N, B]
// (step 4 applied). With S = 0 only the weights are written.
//
// Rounding: the kernel reproduces the plain PyTorch version's, operation by
// operation. Every multiply and add is an explicit __fmul_rn / __fadd_rn, so
// nvcc contracts none of them into an FMA (a contraction moves floor() across
// a cell boundary or a time by an ulp); divisions are IEEE (no fast math);
// bound, scale, width, near and floor come from the host as the float32 values
// torch rounds the Python doubles to. The CDF is summed in double: every
// prefix of B <= 256 weights from {0, floor, 1} is exact there (for a floor
// of at least 2^-21), so rounding each prefix to float gives what PyTorch's
// CPU cumsum gives (a double accumulator, in order), whatever the order of
// the scan. PyTorch's CUDA cumsum sums in float: at the default floor 0.25
// every prefix is exact in float too; at a floor such as 0.1 it may differ
// by an ulp, and a u within that ulp of an edge then takes the next bin.
//
// What bounds it: bytes, and at the main path's sizes the launch. A 4096-ray
// call at S = 16 reads o, d and the draws (~0.36 MB) and writes ts and the
// samples (~1.05 MB): ~0.43 us at 3.35 TB/s, plus B word gathers per ray
// from L2. The TPU version ran ~50 XLA operations and one Pallas call.
//
// Design: one warp per ray, 8 rays per 256-thread block, no block-level
// synchronisation. Lane l takes bins l, l + 32, ...: the weights, then a warp
// scan (__shfl_up_sync, in double) for the CDF, staged in shared memory (B
// floats per warp). Lane l then takes samples l, l + 32, ... and finds each
// bin by a binary search of the staged CDF; with jitter the S times are
// sorted by a bitonic network in shared memory (S rounded up to a power of
// two, padded with +inf). The stores are coalesced: the S times and the 3S
// sample coordinates of a ray are contiguous. The word table is not staged
// in shared memory (256 KiB at G=128 exceeds an SM's; at G=64 every block
// would reload 32 KiB): the words are gathered through __ldg from L1/L2.
// The TPU kernel's one-hot matmul, u16 table halves and [P, 1] probe-major
// padding are workarounds for its missing gather unit and are not copied.

#include <cuda_runtime.h>

#include <cstdint>

#include "occupancy_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_BINS = 256;
constexpr int MAX_SAMPLES = 256;
constexpr int BINS_PER_LANE = MAX_BINS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const unsigned* words;
  long long n_bits;
  const float* o;
  const float* d;
  const float* eps;
  const float* frac;  // [N, S] with in-bin jitter, else null
  float* ts;          // [N, S]
  float* samples;     // [N, S, 3]
  float* weights;     // [N, B] or null
  long long n;
  int g, bins, s, s_pad;
  float bound, scale, width, near, floor_w;
};

__device__ __forceinline__ float pick3(int c, float a, float b, float z) {
  return c == 0 ? a : (c == 1 ? b : z);
}

__global__ void __launch_bounds__(THREADS) sampler_kernel(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * WARPS + warp;
  if (ray >= a.n) return;  // the whole warp leaves together
  float* cdf = smem + warp * (a.bins + a.s_pad);
  float* tsb = cdf + a.bins;

  float o[3], d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(a.o + ray * 3 + c);
    d[c] = __ldg(a.d + ray * 3 + c);
  }

  // 1-3: each lane's bins b = lane + 32 k
  float w[BINS_PER_LANE];
  bool any = false;
#pragma unroll
  for (int k = 0; k < BINS_PER_LANE; ++k) {
    const int b = lane + 32 * k;
    w[k] = 0.f;
    if (b < a.bins) {
      const float mid = __fadd_rn(a.near, __fmul_rn(__fadd_rn((float)b, 0.5f), a.width));
      int v[3];
      bool inside = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pos = __fadd_rn(o[c], __fmul_rn(mid, d[c]));
        v[c] = (int)floorf(__fmul_rn(__fadd_rn(pos, a.bound), a.scale));
        inside = inside && v[c] >= 0 && v[c] < a.g;
        v[c] = min(max(v[c], 0), a.g - 1);
      }
      const int lin = (v[0] * a.g + v[1]) * a.g + v[2];
      const bool occupied = inside && occupancy_bit(a.words, a.n_bits, lin);
      w[k] = occupied ? 1.f : (inside ? a.floor_w : 0.f);
      any = any || w[k] > 0.f;
    }
  }
  // 4: a ray with no positive weight samples uniformly
  if (!__any_sync(FULL, any)) {
#pragma unroll
    for (int k = 0; k < BINS_PER_LANE; ++k) w[k] = lane + 32 * k < a.bins ? 1.f : 0.f;
  }
  if (a.weights) {
#pragma unroll
    for (int k = 0; k < BINS_PER_LANE; ++k) {
      const int b = lane + 32 * k;
      if (b < a.bins) a.weights[ray * a.bins + b] = w[k];
    }
  }
  if (a.s == 0) return;

  // 5: inclusive scan over the bins in double, 32 bins at a time
  float prefix[BINS_PER_LANE];
  double carry = 0.0;
#pragma unroll
  for (int k = 0; k < BINS_PER_LANE; ++k) {
    prefix[k] = 0.f;
    if (32 * k < a.bins) {  // the same for every lane
      double x = (double)w[k];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      x += carry;
      prefix[k] = __double2float_rn(x);
      carry = __shfl_sync(FULL, x, 31);
    }
  }
  const float denom = __fadd_rn(__double2float_rn(carry), 1e-10f);
#pragma unroll
  for (int k = 0; k < BINS_PER_LANE; ++k) {
    const int b = lane + 32 * k;
    if (b < a.bins) cdf[b] = __fdiv_rn(prefix[k], denom);
  }
  __syncwarp();

  // 6-9: each lane's samples s = lane + 32 j
  const float s_f = (float)a.s;
  const float eps = __fdiv_rn(__ldg(a.eps + ray), s_f);
  for (int s = lane; s < a.s_pad; s += 32) {
    float t = __int_as_float(0x7f800000);  // +inf pads the sort
    if (s < a.s) {
      const float u = __fadd_rn(__fdiv_rn((float)s, s_f), eps);
      int lo = 0, hi = a.bins;  // first index with cdf >= u
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (cdf[m] < u) lo = m + 1; else hi = m;
      }
      const int idx = min(lo, a.bins - 1);
      float frac;
      if (a.frac) {
        frac = __ldg(a.frac + ray * a.s + s);
      } else {
        const float c_lo = idx > 0 ? cdf[idx - 1] : 0.f, c_hi = cdf[idx];
        const float span = __fsub_rn(c_hi, c_lo);
        frac = __fdiv_rn(__fsub_rn(u, c_lo), span < 1e-10f ? 1.f : span);
        frac = fminf(fmaxf(frac, 0.f), 1.f);
      }
      t = __fadd_rn(a.near, __fmul_rn(__fadd_rn((float)idx, frac), a.width));
    }
    tsb[s] = t;
  }
  __syncwarp();

  // 10: bitonic sort of the s_pad (a power of two) times, ascending
  if (a.frac) {
    for (int size = 2; size <= a.s_pad; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = lane; i < (a.s_pad >> 1); i += 32) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const float x = tsb[lo], y = tsb[hi];
          if ((x > y) == ((lo & size) == 0)) {
            tsb[lo] = y;
            tsb[hi] = x;
          }
        }
        __syncwarp();
      }
    }
  }

  // 11: the stores, each ray's S times and 3S coordinates contiguous
  float* ts = a.ts + ray * a.s;
  for (int s = lane; s < a.s; s += 32) ts[s] = tsb[s];
  float* out = a.samples + ray * 3 * a.s;
  for (int k = lane; k < 3 * a.s; k += 32) {
    const int s = k / 3, c = k - 3 * s;
    out[k] = __fadd_rn(pick3(c, o[0], o[1], o[2]), __fmul_rn(tsb[s], pick3(c, d[0], d[1], d[2])));
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take. eps, frac, ts and samples may be null when
// s == 0 (weights only); frac is null without in-bin jitter.
extern "C" int occupancy_sampler(const void* words, long long n_words, int g, const void* o,
                                 const void* d, const void* eps, const void* frac, void* ts,
                                 void* samples, void* weights, long long n, int bins, int s,
                                 float bound, float scale, float width, float near,
                                 float floor_w, void* stream) {
  if (n_words < 1 || n < 1 || g < 1 || bins < 1 || bins > MAX_BINS || s < 0 ||
      s > MAX_SAMPLES || (s == 0 && !weights) || (s > 0 && (!eps || !ts || !samples)))
    return -1;
  const long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return -1;
  int s_pad = s;
  if (frac && s > 0) {
    s_pad = 1;
    while (s_pad < s) s_pad <<= 1;
  }
  Args a;
  a.words = static_cast<const unsigned*>(words);
  a.n_bits = 32LL * n_words;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.eps = static_cast<const float*>(eps);
  a.frac = static_cast<const float*>(frac);
  a.ts = static_cast<float*>(ts);
  a.samples = static_cast<float*>(samples);
  a.weights = static_cast<float*>(weights);
  a.n = n;
  a.g = g;
  a.bins = bins;
  a.s = s;
  a.s_pad = s_pad;
  a.bound = bound;
  a.scale = scale;
  a.width = width;
  a.near = near;
  a.floor_w = floor_w;
  const size_t smem = sizeof(float) * WARPS * (size_t)(bins + s_pad);
  sampler_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
