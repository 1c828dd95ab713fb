// The weight-gradient half of both backward passes (fused_raymarch_bwd.cu,
// raymarch_mlp_bwd.cu): from the scratch that their per-point kernel A wrote
// (every layer's input and output gradient, each block of channels its own
// matrix [points][width], fused_raymarch_common.cuh), every out[k, n] =
// sum_p X[p, k] G[p, n] over the points, deterministically:
//   B  `wgrad_mma_kernel` (bf16): a tiled GEMM over the point axis. One CTA
//      (8 warps) owns a 128 x 128 output tile of one product and one fixed
//      slice of the points; it stages [64 points x 128 channels] tiles of
//      both operands in shared memory with 16-byte cp.async in a 3-stage
//      ring (points past the slice zero-filled; each thread's source
//      pointers kept from stage to stage, so a stage costs 8 cp.async and
//      no address arithmetic) and builds every mma.sync fragment with
//      ldmatrix.trans (the operands arrive k-major). The grid runs every
//      tile of one slice before the next slice (blockIdx.x is the tile), so
//      the CTAs that share an operand block read it within a short time of
//      each other and the second read hits L2. Its floor is the scratch's
//      bytes (~117 multiply-adds per byte it must read, below the card's
//      ~295 FLOP/byte ridge); it runs at under half of that floor's rate,
//      on two CTAs of 8 warps per SM (what holds it is not measured yet:
//      the per-stage address arithmetic was part of it).
//      Each slice writes its own partial sums. With bias_partial, the CTAs
//      of the first row tile of the products marked in JOB_TABLE also sum
//      G's columns from the staged tiles, off the tensor cores.
//      `wgrad_fma_kernel` (fp32, the comparison path): one warp per 32 x 64
//      output tile, FMA, the operands read straight from the scratch.
//   R  `reduce_slices`: adds the slices' partial sums in a fixed order;
//      `reduce_rows` adds rows of bias sums (the point backward's per-CTA
//      rows from its kernel A, the fused one's per-slice rows from B) in a
//      fixed order.
// No atomics, and the slices are a fixed function of the point count: two
// launches on the same inputs give bit-identical results.

#pragma once

#include "fused_raymarch_common.cuh"

namespace {

// one product out[k, n] = sum_p X[p, x + k] * G[p, g + n], X the whole
// scratch block at channel x (width k), G the one at g (width n); bias >= 0
// marks the one product per gradient block whose first row tile also sums
// G's columns, into bias sums [bias, bias + n) (when the caller asks)
struct Job {
  int x, k, g, n;
  long long out;
  int bias;
};
constexpr int JOBS = 12;

// in flatten_mlp_params order (the weight blocks of GRAD_BLOCKS in
// fused_raymarch.py)
constexpr Job JOB_TABLE[JOBS] = {
    {C_E, KE, C_GA0, WIDTH, 0, C_GA0 - C_GA0},
    {C_A0, WIDTH, C_GA1, WIDTH, 0, C_GA1 - C_GA0},
    {C_A1, WIDTH, C_GA2, WIDTH, 0, C_GA2 - C_GA0},
    {C_A2, WIDTH, C_GA3, WIDTH, 0, C_GA3 - C_GA0},
    {C_A3, WIDTH, C_GA4, WIDTH, 0, C_GA4 - C_GA0},
    {C_E, KE, C_GA4, WIDTH, 0, -1},
    {C_A4, WIDTH, C_GA5, WIDTH, 0, C_GA5 - C_GA0},
    {C_A5, WIDTH, C_GH, WIDTH, 0, C_GH - C_GA0},
    {C_H, WIDTH, C_HEAD, 8, 0, C_HEAD - C_GA0},
    {C_H, WIDTH, C_GR0, RGB_WIDTH, 0, C_GR0 - C_GA0},
    {C_ED, KD, C_GR0, RGB_WIDTH, 0, -1},
    {C_R0, RGB_WIDTH, C_HEAD, 8, 0, -1},
};

// the bf16 kernel's CTA: 8 warps as 2 (k) x 4 (n), each 64 x WB_N / 4
// outputs; operand tiles of WB_P points, rows padded by 8 bf16 (the 8 rows
// of an ldmatrix fall on distinct banks), WB_STAGES of them in flight
constexpr int WB_M = 128, WB_N = 128, WB_P = 64, WB_STAGES = 3;
constexpr int WB_THREADS = 256;
constexpr size_t WB_SMEM =
    sizeof(__nv_bfloat16) * WB_STAGES * WB_P * ((WB_M + 8) + (WB_N + 8));
// the fp32 kernel: 4 warps per CTA, one 32 x 64 output tile each
constexpr int WF_M = 32, WF_N = 64, WF_WARPS = 4;

struct WgradArgs {
  const void* scratch;
  long long p;  // points
  int chunk;    // points per slice, a multiple of WB_P
  int tm, tn;   // the output tile
  int tiles[JOBS + 1];
  Job jobs[JOBS];
  float* partial;  // [slices][total]
  long long total;
  float* bias_partial;  // [slices][BIAS_CH] column sums of G, or null: none
};

// job and output tile (m0, n0) of tile index `tile`
__device__ __forceinline__ int tile_job(const WgradArgs& a, int tile, int& m0, int& n0) {
  int j = 0;
  while (j + 1 < JOBS && tile >= a.tiles[j + 1]) ++j;
  const int local = tile - a.tiles[j], ntn = (a.jobs[j].n + a.tn - 1) / a.tn;
  m0 = (local / ntn) * a.tm;
  n0 = (local % ntn) * a.tn;
  return j;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(WB_THREADS, 2) wgrad_mma_kernel(WgradArgs a) {
  constexpr int STAGES = WB_STAGES, LDX = WB_M + 8, LDG = WB_N + 8;
  constexpr int NTW = WB_N / 32;  // n-tiles of 8 per warp
  constexpr int STAGE = WB_P * (LDX + LDG);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][X | G]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  int m0, n0;
  const Job jb = a.jobs[tile_job(a, blockIdx.x, m0, n0)];
  const int km = min(WB_M, jb.k - m0), nn = min(WB_N, jb.n - n0);  // multiples of 16 and 8
  const Scratch<const __nv_bfloat16> sc{static_cast<const __nv_bfloat16*>(a.scratch), a.p};
  const long long pb = (long long)blockIdx.y * a.chunk, pe = min(a.p, pb + a.chunk);
  const int iters = (int)((pe - pb + WB_P - 1) / WB_P);

  // one stage: 16-byte pieces of the X rows' km and the G rows' nn channels,
  // thread i moving piece i % XP of rows i / XP + RSTEP * j of both (its
  // source pointers kept from stage to stage); points past the slice read
  // as zeros
  constexpr int XP = WB_M / 8, RSTEP = WB_THREADS / XP;  // pieces per row, rows per pass
  static_assert(WB_M == WB_N && WB_P % RSTEP == 0, "one piece layout for both operands");
  const int lc = threadIdx.x % XP, lr = threadIdx.x / XP;
  const bool xon = lc * 8 < km, gon = lc * 8 < nn;
  const __nv_bfloat16* xsrc = sc.row(jb.x, jb.k, pb) + m0 + lc * 8;
  const __nv_bfloat16* gsrc = sc.row(jb.g, jb.n, pb) + n0 + lc * 8;
  auto load = [&](int it, int buf) {
    __nv_bfloat16* xs = ring + (size_t)buf * STAGE + lr * LDX + lc * 8;
    __nv_bfloat16* gs = ring + (size_t)buf * STAGE + WB_P * LDX + lr * LDG + lc * 8;
#pragma unroll
    for (int j = 0; j < WB_P / RSTEP; ++j) {
      const long long row = (long long)it * WB_P + j * RSTEP + lr;  // from pb
      const bool in = pb + row < pe;
      const long long off = in ? row : 0;  // past the slice: row pb, no bytes read
      if (xon) cp_async16(xs + j * RSTEP * LDX, xsrc + off * jb.k, in ? 16 : 0);
      if (gon) cp_async16(gs + j * RSTEP * LDG, gsrc + off * jb.n, in ? 16 : 0);
    }
  };

  float acc[4][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // this warp's valid 16-row and 8-column pieces (warp-uniform)
  const int mts = max(0, min(4, (km - wm * 64) / 16));
  const int nts = max(0, min(NTW, (nn - wn * NTW * 8) / 8));
  // the CTA that sums G's columns: thread i adds the column pair
  // i % BPAIRS of the stage rows [i / BPAIRS * BR, + BR); the BGROUPS
  // partial sums of a column are added in order at the end
  constexpr int BPAIRS = WB_N / 2, BGROUPS = WB_THREADS / BPAIRS, BR = WB_P / BGROUPS;
  const bool bias = a.bias_partial != nullptr && jb.bias >= 0 && m0 == 0;
  const int bcol = threadIdx.x % BPAIRS * 2, bgroup = threadIdx.x / BPAIRS;
  float bsum0 = 0.f, bsum1 = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` is in; every warp is done with the buffer refilled next
    if (it + STAGES - 1 < iters) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (size_t)(it % STAGES) * STAGE;
    const __nv_bfloat16* gs = xs + WB_P * LDX;
    if (bias && bcol < nn) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(gs + (bgroup * BR + r) * LDG + bcol);
        bsum0 += __low2float(v);
        bsum1 += __high2float(v);
      }
    }
    if (mts == 0 || nts == 0) continue;
#pragma unroll
    for (int kk = 0; kk < WB_P / 16; ++kk) {
      // A (rows k, cols p) from X^T: matrices (k 0-7 | 8-15) x (p 0-7 | 8-15);
      // B (p x n) from G: (p 0-7 | 8-15) x (n-tile nt | nt + 1)
      const int i = lane >> 3, r = lane & 7;
      uint32_t af[4][4], bf[NTW / 2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (mt < mts)
          ldmatrix_x4<true>(af[mt], xs + (kk * 16 + r + (i >> 1) * 8) * LDX + wm * 64 + mt * 16 +
                                        (i & 1) * 8);
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np)
        if (np * 2 < nts)
          ldmatrix_x4<true>(bf[np], gs + (kk * 16 + r + (i & 1) * 8) * LDG + wn * NTW * 8 +
                                        (np * 2 + (i >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          if (mt < mts && nt < nts)
            mma_bf16(acc[mt][nt], af[mt],
                     make_uint2(bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]));
    }
  }
  float* out = a.partial + (long long)blockIdx.y * a.total + jb.out;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      if (mt < mts && nt < nts) {
        const int row = m0 + wm * 64 + mt * 16 + g, col = n0 + wn * NTW * 8 + nt * 8 + t * 2;
        *reinterpret_cast<float2*>(out + (long long)row * jb.n + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * jb.n + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  if (bias) {
    __syncthreads();  // every warp is done with the ring, every load landed
    float* part = reinterpret_cast<float*>(smem);  // [BGROUPS][WB_N]
    part[bgroup * WB_N + bcol] = bsum0;
    part[bgroup * WB_N + bcol + 1] = bsum1;
    __syncthreads();
    if ((int)threadIdx.x < nn) {
      float v = part[threadIdx.x];
#pragma unroll
      for (int k = 1; k < BGROUPS; ++k) v += part[k * WB_N + threadIdx.x];
      a.bias_partial[(long long)blockIdx.y * BIAS_CH + jb.bias + n0 + threadIdx.x] = v;
    }
  }
}

// fp32: lane owns columns n0 + lane and n0 + 32 + lane of the 32 rows
__global__ void __launch_bounds__(WF_WARPS * 32) wgrad_fma_kernel(WgradArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WF_WARPS + warp;
  if (tile >= a.tiles[JOBS]) return;
  int m0, n0;
  const Job jb = a.jobs[tile_job(a, tile, m0, n0)];
  const Scratch<const float> sc{static_cast<const float*>(a.scratch), a.p};
  const int c0 = n0 + lane, c1 = n0 + 32 + lane;
  const bool v0 = c0 < jb.n, v1 = c1 < jb.n;
  float acc[WF_M][2];
#pragma unroll
  for (int r = 0; r < WF_M; ++r) acc[r][0] = acc[r][1] = 0.f;
  float bs0 = 0.f, bs1 = 0.f;  // G's column sums, kept by the first row tile
  const long long pb = (long long)blockIdx.y * a.chunk, pe = min(a.p, pb + a.chunk);
  for (long long p = pb; p < pe; ++p) {
    const float* gr = sc.row(jb.g, jb.n, p);
    const float ga = v0 ? gr[c0] : 0.f, gb = v1 ? gr[c1] : 0.f;
    bs0 += ga;
    bs1 += gb;
    const float* x = sc.row(jb.x, jb.k, p) + m0;  // k is a multiple of WF_M
#pragma unroll
    for (int r = 0; r < WF_M; ++r) {
      acc[r][0] = fmaf(x[r], ga, acc[r][0]);
      acc[r][1] = fmaf(x[r], gb, acc[r][1]);
    }
  }
  float* out = a.partial + (long long)blockIdx.y * a.total + jb.out;
#pragma unroll
  for (int r = 0; r < WF_M; ++r) {
    if (v0) out[(m0 + r) * jb.n + c0] = acc[r][0];
    if (v1) out[(m0 + r) * jb.n + c1] = acc[r][1];
  }
  if (a.bias_partial != nullptr && jb.bias >= 0 && m0 == 0) {
    float* bout = a.bias_partial + (long long)blockIdx.y * BIAS_CH + jb.bias;
    if (v0) bout[c0] = bs0;
    if (v1) bout[c1] = bs1;
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

// out[i] = sum over rows of part[row][i] (many rows, few columns) in a fixed
// order: thread y of column i sums rows y, y + 32, ... in turn, then the 32
// partial sums are added in y order
constexpr int RR_GROUPS = 32;
__global__ void __launch_bounds__(32 * RR_GROUPS) reduce_rows(const float* part, long long rows,
                                                              int cols, float* out) {
  __shared__ float s[RR_GROUPS][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (i < cols)
    for (long long r = threadIdx.y; r < rows; r += RR_GROUPS) v += part[r * cols + i];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && i < cols) {
    float total = s[0][threadIdx.x];
    for (int k = 1; k < RR_GROUPS; ++k) total += s[k][threadIdx.x];
    out[i] = total;
  }
}

int launch_reduce_rows(const float* part, long long rows, int cols, float* out,
                       cudaStream_t stream) {
  reduce_rows<<<(cols + 31) / 32, dim3(32, RR_GROUPS), 0, stream>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

// the weight-gradient work over p points: slices and the products of
// JOB_TABLE (their offsets in the output)
struct Plan {
  long long p, total;
  int slices, chunk;
  Job jobs[JOBS];
};

inline Plan make_plan(long long p) {
  Plan pl;
  pl.p = p;
  // a fixed function of the point count: the sums' order never depends on
  // the card or the run
  long long slices = (p + 4095) / 4096;
  slices = slices < 1 ? 1 : (slices > 64 ? 64 : slices);
  pl.chunk = (int)(((p + slices - 1) / slices + WB_P - 1) / WB_P * WB_P);
  pl.slices = (int)((p + pl.chunk - 1) / pl.chunk);
  long long off = 0;
  for (int j = 0; j < JOBS; ++j) {
    pl.jobs[j] = JOB_TABLE[j];
    pl.jobs[j].out = off;
    off += (long long)pl.jobs[j].k * pl.jobs[j].n;
  }
  pl.total = off;
  return pl;
}

// kernel B and the reduction R: grads [pl.total] from the scratch, through
// partial [pl.slices][pl.total]; with bias_partial, also each slice's
// column sums of the gradient blocks, bias_partial [pl.slices][BIAS_CH]
template <class T>
int launch_wgrad(const Plan& pl, const void* scratch, float* partial, float* grads,
                 float* bias_partial, cudaStream_t stream) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
  WgradArgs w;
  w.scratch = scratch;
  w.p = pl.p;
  w.chunk = pl.chunk;
  w.tm = BF16 ? WB_M : WF_M;
  w.tn = BF16 ? WB_N : WF_N;
  w.tiles[0] = 0;
  for (int j = 0; j < JOBS; ++j) {
    w.jobs[j] = pl.jobs[j];
    w.tiles[j + 1] = w.tiles[j] + ((pl.jobs[j].k + w.tm - 1) / w.tm) *
                                      ((pl.jobs[j].n + w.tn - 1) / w.tn);
  }
  w.partial = partial;
  w.total = pl.total;
  w.bias_partial = bias_partial;
  cudaError_t err;
  if constexpr (BF16) {
    err = cudaFuncSetAttribute(wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WB_SMEM);
    if (err != cudaSuccess) return (int)err;
    wgrad_mma_kernel<<<dim3(w.tiles[JOBS], pl.slices), WB_THREADS, WB_SMEM, stream>>>(w);
  } else {
    const dim3 grid((w.tiles[JOBS] + WF_WARPS - 1) / WF_WARPS, pl.slices);
    wgrad_fma_kernel<<<grid, WF_WARPS * 32, 0, stream>>>(w);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_slices<<<(unsigned)((pl.total + 255) / 256), 256, 0, stream>>>(partial, pl.slices,
                                                                         pl.total, grads);
  return (int)cudaGetLastError();
}

}  // namespace
