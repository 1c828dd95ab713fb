// The weight-gradient half of both backward passes (fused_raymarch_bwd.cu,
// raymarch_mlp_bwd.cu): from the scratch that their per-point kernel wrote
// (every layer's input and output gradient, feature-major [channel, point],
// fused_raymarch_common.cuh), every out[k, n] = sum_p X[k, p] G[n, p] over
// the points, deterministically:
//   B  `wgrad_*_kernel`: one warp per 32 x 64 output tile of one product,
//      over a fixed slice of the points, mma.sync bf16 with fp32
//      accumulation (FMA in fp32), fragments loaded straight from the
//      feature-major scratch (both operands are contiguous along the point
//      axis). A row of ones in place of X gives a bias gradient (the column
//      sums of G). Each slice writes its own partial sums.
//   R  `reduce_slices`: adds the slices' partial sums in a fixed order.
// No atomics: two launches on the same inputs give bit-identical results.

#pragma once

#include "fused_raymarch_common.cuh"

namespace {

// one product out[k, n] = sum_p X[x + k, p] * G[g + n, p]; x < 0: a row of
// ones (the column sums of G)
struct Job {
  int x, k, g, n;
  long long out;
};
constexpr int JOBS = 21;
constexpr int WEIGHT_JOBS = 12;  // the weight products; the rest are bias sums
constexpr int WG_WARPS = 4;  // warps per CTA, one 32 x 64 output tile each

// in flatten_mlp_params order, then the bias sums (GRAD_BLOCKS in
// fused_raymarch.py)
constexpr Job JOB_TABLE[JOBS] = {
    {C_E, KE, C_GA0, WIDTH, 0},      {C_A0, WIDTH, C_GA1, WIDTH, 0},
    {C_A1, WIDTH, C_GA2, WIDTH, 0},  {C_A2, WIDTH, C_GA3, WIDTH, 0},
    {C_A3, WIDTH, C_GA4, WIDTH, 0},  {C_E, KE, C_GA4, WIDTH, 0},
    {C_A4, WIDTH, C_GA5, WIDTH, 0},  {C_A5, WIDTH, C_GH, WIDTH, 0},
    {C_H, WIDTH, C_HEAD, 8, 0},      {C_H, WIDTH, C_GR0, RGB_WIDTH, 0},
    {C_ED, KD, C_GR0, RGB_WIDTH, 0}, {C_R0, RGB_WIDTH, C_HEAD, 8, 0},
    {-1, 32, C_GA0, WIDTH, 0},       {-1, 32, C_GA1, WIDTH, 0},
    {-1, 32, C_GA2, WIDTH, 0},       {-1, 32, C_GA3, WIDTH, 0},
    {-1, 32, C_GA4, WIDTH, 0},       {-1, 32, C_GA5, WIDTH, 0},
    {-1, 32, C_GH, WIDTH, 0},        {-1, 32, C_GR0, RGB_WIDTH, 0},
    {-1, 32, C_HEAD, 8, 0},
};

struct WgradArgs {
  const void* scratch;
  long long pal, p;  // padded and real points per channel
  int chunk;         // points per slice, a multiple of 16
  int tiles[JOBS + 1];
  Job jobs[JOBS];
  float* partial;    // [slices][total]
  long long total;
};

// this warp's job and its output tile (m0, n0)
__device__ __forceinline__ int warp_tile(const WgradArgs& a, int tile, int& m0, int& n0) {
  int j = 0;
  while (j + 1 < JOBS && tile >= a.tiles[j + 1]) ++j;
  const int local = tile - a.tiles[j], ntn = (a.jobs[j].n + 63) / 64;
  m0 = (local / ntn) * 32;
  n0 = (local % ntn) * 64;
  return j;
}

// elements p, p+1 of a bf16 row as one mma operand register; zeros past n
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, long long p, long long n) {
  if (p + 1 < n) return __ldg(reinterpret_cast<const unsigned int*>(row + p));
  if (p < n) return (uint32_t)__bfloat16_as_ushort(row[p]);
  return 0u;
}

__global__ void __launch_bounds__(WG_WARPS * 32) wgrad_mma_kernel(WgradArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x * WG_WARPS + warp;
  if (tile >= a.tiles[JOBS]) return;
  int m0, n0;
  const Job jb = a.jobs[warp_tile(a, tile, m0, n0)];
  const int nt = min(8, (jb.n - n0) / 8);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(a.scratch);
  const __nv_bfloat16* xr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    xr[r] = jb.x < 0 ? sc : sc + (jb.x + m0 + (r >> 1) * 16 + (r & 1) * 8 + g) * a.pal;
  const __nv_bfloat16* gr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) gr[j] = sc + (jb.g + n0 + min(j, nt - 1) * 8 + g) * a.pal;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const long long pb = (long long)blockIdx.y * a.chunk, pe = min(a.p, pb + a.chunk);
  for (long long p = pb; p < pe; p += 16) {
    const long long pa = p + t * 2, pc = pa + 8;
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (jb.x < 0) {
        af[mt][0] = af[mt][1] = af[mt][2] = af[mt][3] = 0x3F803F80u;  // bf16 1.0 pairs
      } else {
        af[mt][0] = ld_pair(xr[mt * 2], pa, a.p);
        af[mt][1] = ld_pair(xr[mt * 2 + 1], pa, a.p);
        af[mt][2] = ld_pair(xr[mt * 2], pc, a.p);
        af[mt][3] = ld_pair(xr[mt * 2 + 1], pc, a.p);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        const uint2 b = make_uint2(ld_pair(gr[j], pa, a.p), ld_pair(gr[j], pc, a.p));
        mma_bf16(acc[0][j], af[0], b);
        mma_bf16(acc[1][j], af[1], b);
      }
    }
  }
  float* out = a.partial + (long long)blockIdx.y * a.total + jb.out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        const int row = m0 + mt * 16 + g, col = n0 + j * 8 + t * 2;
        out[row * jb.n + col] = acc[mt][j][0];
        out[row * jb.n + col + 1] = acc[mt][j][1];
        out[(row + 8) * jb.n + col] = acc[mt][j][2];
        out[(row + 8) * jb.n + col + 1] = acc[mt][j][3];
      }
    }
}

// four consecutive points of an fp32 row; zeros past n
__device__ __forceinline__ float4 ld_quad(const float* row, long long p, long long n) {
  if (p + 4 <= n) return __ldg(reinterpret_cast<const float4*>(row + p));
  return make_float4(p < n ? row[p] : 0.f, p + 1 < n ? row[p + 1] : 0.f,
                     p + 2 < n ? row[p + 2] : 0.f, p + 3 < n ? row[p + 3] : 0.f);
}

// fp32: lane owns columns n0 + lane and n0 + 32 + lane of the 32 rows
__global__ void __launch_bounds__(WG_WARPS * 32) wgrad_fma_kernel(WgradArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WG_WARPS + warp;
  if (tile >= a.tiles[JOBS]) return;
  int m0, n0;
  const Job jb = a.jobs[warp_tile(a, tile, m0, n0)];
  const float* sc = static_cast<const float*>(a.scratch);
  const int c0 = n0 + lane, c1 = n0 + 32 + lane;
  const bool v0 = c0 < jb.n, v1 = c1 < jb.n;
  const float* g0 = sc + (jb.g + (v0 ? c0 : 0)) * a.pal;
  const float* g1 = sc + (jb.g + (v1 ? c1 : 0)) * a.pal;
  float acc[32][2];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r][0] = acc[r][1] = 0.f;
  const long long pb = (long long)blockIdx.y * a.chunk, pe = min(a.p, pb + a.chunk);
  for (long long p = pb; p < pe; p += 4) {
    const float4 ga = ld_quad(g0, p, a.p), gb = ld_quad(g1, p, a.p);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float4 x = jb.x < 0 ? make_float4(1.f, 1.f, 1.f, 1.f)
                                : ld_quad(sc + (jb.x + m0 + r) * a.pal, p, a.p);
      acc[r][0] = fmaf(x.w, ga.w, fmaf(x.z, ga.z, fmaf(x.y, ga.y, fmaf(x.x, ga.x, acc[r][0]))));
      acc[r][1] = fmaf(x.w, gb.w, fmaf(x.z, gb.z, fmaf(x.y, gb.y, fmaf(x.x, gb.x, acc[r][1]))));
    }
  }
  float* out = a.partial + (long long)blockIdx.y * a.total + jb.out;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (v0) out[(m0 + r) * jb.n + c0] = acc[r][0];
    if (v1) out[(m0 + r) * jb.n + c1] = acc[r][1];
  }
}

// out[i] = sum over slices of partial[slice][i], in slice order
__global__ void reduce_slices(const float* partial, int slices, long long total, float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += partial[k * total + i];
  out[i] = s;
}

// the weight-gradient work over p points: scratch columns, slices, and the
// first njobs products of JOB_TABLE (their output tiles and offsets)
struct Plan {
  long long p, pal, total;
  int slices, chunk;
  int tiles[JOBS + 1];
  Job jobs[JOBS];
};

inline Plan make_plan(long long p, int njobs) {
  Plan pl;
  pl.p = p;
  pl.pal = (p + 15) / 16 * 16;
  // a fixed function of the point count: the sums' order never depends on
  // the card or the run
  long long slices = (p + 4095) / 4096;
  slices = slices < 1 ? 1 : (slices > 64 ? 64 : slices);
  pl.chunk = (int)(((p + slices - 1) / slices + 15) / 16 * 16);
  pl.slices = (int)((p + pl.chunk - 1) / pl.chunk);
  long long off = 0;
  pl.tiles[0] = 0;
  for (int j = 0; j < JOBS; ++j) {
    pl.jobs[j] = JOB_TABLE[j];
    pl.jobs[j].out = off;
    const bool run = j < njobs;  // a job past njobs has no tiles and no output
    off += run ? (long long)pl.jobs[j].k * pl.jobs[j].n : 0;
    pl.tiles[j + 1] =
        pl.tiles[j] + (run ? (pl.jobs[j].k / 32) * ((pl.jobs[j].n + 63) / 64) : 0);
  }
  pl.total = off;
  return pl;
}

// kernel B and the reduction R: grads [pl.total] from the scratch, through
// partial [pl.slices][pl.total]
template <class T>
int launch_wgrad(const Plan& pl, const void* scratch, float* partial, float* grads,
                 cudaStream_t stream) {
  WgradArgs w;
  w.scratch = scratch;
  w.pal = pl.pal;
  w.p = pl.p;
  w.chunk = pl.chunk;
  for (int j = 0; j <= JOBS; ++j) w.tiles[j] = pl.tiles[j];
  for (int j = 0; j < JOBS; ++j) w.jobs[j] = pl.jobs[j];
  w.partial = partial;
  w.total = pl.total;
  const dim3 grid((pl.tiles[JOBS] + WG_WARPS - 1) / WG_WARPS, pl.slices);
  if (std::is_same<T, float>::value)
    wgrad_fma_kernel<<<grid, WG_WARPS * 32, 0, stream>>>(w);
  else
    wgrad_mma_kernel<<<grid, WG_WARPS * 32, 0, stream>>>(w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_slices<<<(unsigned)((pl.total + 255) / 256), 256, 0, stream>>>(partial, pl.slices,
                                                                         pl.total, grads);
  return (int)cudaGetLastError();
}

}  // namespace
