// Fused ray-march backward pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_bwd_kernel` of
// minimal_nerf_tpu/kernels/fused_raymarch.py (launched by `_fused_backward`,
// the custom VJP of `_fused_core`). From o, d [N, 3], ts [N, S], the color
// cotangent dcolor [N, 3] and (optionally) the weights cotangent
// dweights [N, S] it computes the 12 weight gradients and 10 bias gradients
// of the MLP, fp32, summed over all rays:
//   * the forward again (same code as fused_raymarch_fwd.cu, so the same
//     rounding: encodings and activations in the compute dtype);
//   * compositing backward per ray: g_rgb = w * dcolor,
//     g_w = <dcolor, rgb> + dweights,
//     g_sigma_i = delta_i * (T_i e_i g_w_i - sum_{j>i} w_j g_w_j);
//   * the reverse sweep through the heads and the trunk (products with W^T),
//     each gradient activation masked by its ReLU and rounded to the
//     compute dtype where JAX rounds it (`gact`, g_rgbpre, g_sigpre);
//   * every weight gradient A^T G and bias gradient (column sums of G).
//
// Design. The TPU grid runs in order and adds each step's products into one
// output; CTAs run in parallel, and the sum over rays must not depend on
// their order. So the work is split in three launches, none of which uses
// atomics, and two launches on the same inputs give bit-identical results:
//   A  `fused_bwd_kernel`: one CTA per group of whole rays, as the forward.
//      It recomputes the forward tile by tile, keeping each layer's input
//      activation (e, ed, a0..a5, h, r0), runs the compositing backward per
//      ray (one warp, shuffle scans for the prefix and the suffix sums), then
//      the reverse sweep tile by tile on the tensor cores (the wrapper packs
//      W^T in mma fragment order), keeping each layer's output gradient
//      (g_a0..g_a5, g_h, g_r0, and g_sigpre | g_rgbpre in one 8-channel
//      block). Both go to a device scratch buffer in the compute dtype,
//      feature-major [channel, point]: 3,944 channels, 7.9 KB per point in
//      bf16.
//   B  `wgrad_*_kernel`: for every layer, out[k, n] = sum_p X[k, p] G[n, p]
//      over a fixed slice of the points, one warp per 32 x 64 output tile,
//      mma.sync bf16 with fp32 accumulation (FMA in fp32), fragments loaded
//      straight from the feature-major scratch (both operands are
//      contiguous along the point axis). A row of ones in place of X gives
//      the bias gradients. Each slice writes its own partial sums.
//   R  `reduce_slices`: adds the slices' partial sums in a fixed order.
//
// What bounds it: tensor-core operations, 1,347,456 multiply-adds per point
// (forward recomputed, activation gradients, weight gradients), against
// ~16 KB of scratch written and read per point in bf16. This first version
// is simple rather than fast: kernel A re-reads the ReLU masks from device
// memory and writes the scratch with strided shared-memory reads; kernel B
// reads its operands from L2 / device memory with no shared-memory staging.
// Ragged edges: rays past N take zero cotangents, so they add exact zeros;
// rows past a CTA's last sample are never stored; points past the end are
// read as zeros.

#include "fused_raymarch_common.cuh"

namespace {

// scratch channel blocks ([channel][point]): layer inputs, then layer
// output gradients (the order of SCRATCH_CHANNELS in fused_raymarch.py)
enum : int {
  C_E = 0,
  C_ED = C_E + KE,
  C_A0 = C_ED + KD,
  C_A1 = C_A0 + WIDTH,
  C_A2 = C_A1 + WIDTH,
  C_A3 = C_A2 + WIDTH,
  C_A4 = C_A3 + WIDTH,
  C_A5 = C_A4 + WIDTH,
  C_H = C_A5 + WIDTH,
  C_R0 = C_H + WIDTH,
  C_GA0 = C_R0 + RGB_WIDTH,
  C_GA1 = C_GA0 + WIDTH,
  C_GA2 = C_GA1 + WIDTH,
  C_GA3 = C_GA2 + WIDTH,
  C_GA4 = C_GA3 + WIDTH,
  C_GA5 = C_GA4 + WIDTH,
  C_GH = C_GA5 + WIDTH,
  C_GR0 = C_GH + WIDTH,
  C_HEAD = C_GR0 + RGB_WIDTH,  // g_sigpre, g_rgbpre[3], 4 zeros
  CHANNELS = C_HEAD + 8,
};

// the transposed weights of the reverse sweep
enum { T1T, T2T, T3T, F0HT, F1T, F2T, R0HT };

struct BwdArgs : RayArgs {
  const float* dcolor;
  const float* dweights;  // may be null: zeros
  const void* wt[7];
  void* scratch;
  long long pal;  // points per scratch channel (padded)
};

// the forward's buffers plus two per-sample temporaries of the compositing
// backward
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD)) +
         sizeof(float) * 6 * MAX_RAY_ROWS + sizeof(T) * MAX_RAYS * (KD + PAD) +
         sizeof(float) * M * 4;
}

// rows [0, rows) of a tile [M, ld] -> scratch channels [ch][p0 + row]
template <class T>
__device__ void store_cols(const T* src, int ld, int ch, T* dst, long long pal, long long p0,
                           int rows) {
  constexpr int M = Tile<T>::M;
  for (int idx = threadIdx.x; idx < M * ch; idx += THREADS) {
    const int c = idx / M, r = idx % M;
    if (r < rows) dst[c * pal + p0 + r] = src[r * ld + c];
  }
}

// a ReLU layer's input gradient: the product where the layer's stored
// activation is > 0, else 0
template <class T>
struct MaskAct {
  const T* act;
  long long pal, p0;
  int rows;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    return row < rows && tof(act[col * pal + p0 + row]) > 0.f ? v : 0.f;
  }
};

// g_h = g_r0 @ R0H^T + g_sigpre * dw (no activation)
template <class T>
struct HeadGrad {
  const float* gsig;
  const T* dw;
  int rows;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    return row < rows ? __fadd_rn(v, __fmul_rn(gsig[row], tof(dw[col]))) : 0.f;
  }
};

// compositing backward of one ray (one warp). sig/rgb hold the ray's sigma
// and rgb and receive g_sigpre and g_rgbpre (rounded to T); wg, aa are
// per-sample temporaries.
template <class T>
__device__ void composite_ray_bwd(const BwdArgs& a, int ray, float* sig, float* rgb, float* wg,
                                  float* aa) {
  const int lane = threadIdx.x & 31, s = a.s;
  const float* t = a.ts + (size_t)ray * s;
  const int per = (s + 31) / 32, lo = min(lane * per, s), hi = min(lo + per, s);
  auto ndd = [&](int i) { return __fmul_rn(-sig[i], sample_delta(t, i, s)); };
  float own = 0.f;
  for (int i = lo; i < hi; ++i) own += ndd(i);
  float inc = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  float run = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) run = 0.f;
  const float dc[3] = {a.dcolor[ray * 3 + 0], a.dcolor[ray * 3 + 1], a.dcolor[ray * 3 + 2]};
  const float* dwt = a.dweights != nullptr ? a.dweights + (size_t)ray * s : nullptr;
  float own_wg = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float v = ndd(i);
    const float trans = expf(run), ealpha = expf(v);
    const float w = (1.f - ealpha) * trans;
    run += v;
    float* c = rgb + i * 3;
    float gw = __fadd_rn(__fadd_rn(__fmul_rn(dc[0], c[0]), __fmul_rn(dc[1], c[1])),
                         __fmul_rn(dc[2], c[2]));
    if (dwt != nullptr) gw = __fadd_rn(gw, dwt[i]);
    wg[i] = __fmul_rn(w, gw);
    own_wg += wg[i];
    aa[i] = __fmul_rn(__fmul_rn(trans, ealpha), gw);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[k] = tof(fromf<T>(__fmul_rn(__fmul_rn(__fmul_rn(w, dc[k]), c[k]), __fsub_rn(1.f, c[k]))));
  }
  // the sum of w_j g_j over the samples of the lanes above this one
  float suf = own_wg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(FULL, suf, off);
    if (lane + off < 32) suf += y;
  }
  float after = __shfl_down_sync(FULL, suf, 1);
  if (lane == 31) after = 0.f;
  for (int i = hi - 1; i >= lo; --i) {
    const float gsig = __fmul_rn(sample_delta(t, i, s), __fsub_rn(aa[i], after));
    after += wg[i];
    sig[i] = sig[i] > 0.f ? tof(fromf<T>(gsig)) : 0.f;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS) fused_bwd_kernel(BwdArgs a) {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  T* Q = P + M * LDW;
  T* E = Q + M * LDW;
  T* D = E + M * LDE;
  float* sig = reinterpret_cast<float*>(D + M * LDD);
  float* rgb = sig + MAX_RAY_ROWS;
  float* wg = rgb + 3 * MAX_RAY_ROWS;
  float* aa = wg + MAX_RAY_ROWS;
  T* dray = reinterpret_cast<T*>(aa + MAX_RAY_ROWS);
  float* xs = reinterpret_cast<float*>(dray + MAX_RAYS * LDD);
  int* rayl = reinterpret_cast<int*>(xs + 3 * M);

  T* sc = static_cast<T*>(a.scratch);
  const long long pal = a.pal;
  auto chan = [&](int c) { return sc + (long long)c * pal; };
  const int ray0 = blockIdx.x * a.rays_per_cta;
  const int rows_total = a.rays_per_cta * a.s;
  const long long cta_p0 = (long long)blockIdx.x * rows_total;

  // 1. the forward, keeping every layer's input (see fused_raymarch_fwd.cu;
  // each store reads a buffer that the next layer only reads)
  encode_dirs<T>(a, ray0, dray, LDD);
  __syncthreads();
  for (int row_base = 0; row_base < rows_total; row_base += M) {
    const long long p0 = cta_p0 + row_base;
    const int rows = min(M, rows_total - row_base);
    encode_tile<T>(a, ray0, row_base, E, LDE, D, dray, LDD, xs, rayl);
    __syncthreads();
    store_cols<T>(E, LDE, KE, chan(C_E), pal, p0, rows);
    store_cols<T>(D, LDD, KD, chan(C_ED), pal, p0, rows);
    dense<WIDTH, T>(E, LDE, KE, a.w[T0], nullptr, 0, 0, nullptr,
                    BiasAct<true>{a.b[T0B]}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_A0), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.w[T1], nullptr, 0, 0, nullptr,
                    BiasAct<true>{a.b[T1B]}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_A1), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.w[T2], nullptr, 0, 0, nullptr,
                    BiasAct<true>{a.b[T2B]}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_A2), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.w[T3], nullptr, 0, 0, nullptr,
                    BiasAct<true>{a.b[T3B]}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_A3), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F0H], E, LDE, KE, a.w[F0E],
                    BiasAct<true>{a.b[F0B]}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_A4), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.w[F1], nullptr, 0, 0, nullptr,
                    BiasAct<true>{a.b[F1B]}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_A5), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F2], nullptr, 0, 0, nullptr,
                    BiasAct<false>{a.b[F2B]}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_H), pal, p0, rows);
    dense<RGB_WIDTH, T>(P, LDW, WIDTH, a.w[R0H], D, LDD, KD, a.w[R0D],
                        BiasAct<true>{a.b[R0B]}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, RGB_WIDTH, chan(C_R0), pal, p0, rows);
    heads<T>(a, P, Q, LDW, row_base, rows_total, sig, rgb);
  }
  __syncthreads();

  // 2. compositing backward: sig <- g_sigpre, rgb <- g_rgbpre; rays past N
  // take zero cotangents
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < a.rays_per_cta; r += THREADS / 32) {
    const int ray = ray0 + r;
    float* rs = sig + r * a.s;
    float* rr = rgb + r * a.s * 3;
    if (ray < a.n) {
      composite_ray_bwd<T>(a, ray, rs, rr, wg + r * a.s, aa + r * a.s);
    } else {
      for (int i = lane; i < a.s; i += 32) rs[i] = rr[i * 3] = rr[i * 3 + 1] = rr[i * 3 + 2] = 0.f;
    }
  }
  __syncthreads();

  // 3. the reverse sweep, tile by tile, keeping every layer's output gradient
  const T* r1w = static_cast<const T*>(a.w[R1]);  // [3, RGB_WIDTH]
  for (int row_base = 0; row_base < rows_total; row_base += M) {
    const long long p0 = cta_p0 + row_base;
    const int rows = min(M, rows_total - row_base);
    for (int idx = threadIdx.x; idx < M * 8; idx += THREADS) {
      const int c = idx / M, r = idx % M, row = row_base + r;
      if (r < rows)
        chan(C_HEAD + c)[p0 + r] =
            fromf<T>(c == 0 ? sig[row] : (c < 4 ? rgb[row * 3 + c - 1] : 0.f));
    }
    // g_r0 = (g_rgbpre @ r1w^T) masked by r0 > 0
    for (int idx = threadIdx.x; idx < M * RGB_WIDTH; idx += THREADS) {
      const int r = idx / RGB_WIDTH, j = idx % RGB_WIDTH;
      float v = 0.f;
      if (r < rows && tof(chan(C_R0 + j)[p0 + r]) > 0.f) {
        const float* g = rgb + (row_base + r) * 3;
        v = __fadd_rn(__fadd_rn(__fmul_rn(g[0], tof(r1w[j])),
                                __fmul_rn(g[1], tof(r1w[RGB_WIDTH + j]))),
                      __fmul_rn(g[2], tof(r1w[2 * RGB_WIDTH + j])));
      }
      P[r * LDW + j] = fromf<T>(v);
    }
    __syncthreads();
    store_cols<T>(P, LDW, RGB_WIDTH, chan(C_GR0), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, RGB_WIDTH, a.wt[R0HT], nullptr, 0, 0, nullptr,
                    HeadGrad<T>{sig + row_base, static_cast<const T*>(a.w[DW]), rows}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_GH), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.wt[F2T], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A5), pal, p0, rows}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_GA5), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.wt[F1T], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A4), pal, p0, rows}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_GA4), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.wt[F0HT], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A3), pal, p0, rows}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_GA3), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.wt[T3T], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A2), pal, p0, rows}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_GA2), pal, p0, rows);
    dense<WIDTH, T>(Q, LDW, WIDTH, a.wt[T2T], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A1), pal, p0, rows}, P, LDW);
    __syncthreads();
    store_cols<T>(P, LDW, WIDTH, chan(C_GA1), pal, p0, rows);
    dense<WIDTH, T>(P, LDW, WIDTH, a.wt[T1T], nullptr, 0, 0, nullptr,
                    MaskAct<T>{chan(C_A0), pal, p0, rows}, Q, LDW);
    __syncthreads();
    store_cols<T>(Q, LDW, WIDTH, chan(C_GA0), pal, p0, rows);
  }
}

// ----------------------------------------------------- weight gradients

// one product out[k, n] = sum_p X[x + k, p] * G[g + n, p]; x < 0: a row of
// ones (the column sums of G)
struct Job {
  int x, k, g, n;
  long long out;
};
constexpr int JOBS = 21;
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

// the sizes of one backward: points, scratch columns, slices, tiles, jobs
struct Plan {
  long long p, pal, total;
  int rays, grid, slices, chunk;
  int tiles[JOBS + 1];
  Job jobs[JOBS];
};

Plan make_plan(int n, int s) {
  Plan pl;
  pl.rays = rays_per_cta(s);
  pl.grid = (n + pl.rays - 1) / pl.rays;
  pl.p = (long long)pl.grid * pl.rays * s;
  pl.pal = (pl.p + 15) / 16 * 16;
  // a fixed function of the point count: the sums' order never depends on
  // the card or the run
  long long slices = (pl.p + 4095) / 4096;
  slices = slices < 1 ? 1 : (slices > 64 ? 64 : slices);
  pl.chunk = (int)(((pl.p + slices - 1) / slices + 15) / 16 * 16);
  pl.slices = (int)((pl.p + pl.chunk - 1) / pl.chunk);
  long long off = 0;
  pl.tiles[0] = 0;
  for (int j = 0; j < JOBS; ++j) {
    pl.jobs[j] = JOB_TABLE[j];
    pl.jobs[j].out = off;
    off += (long long)pl.jobs[j].k * pl.jobs[j].n;
    pl.tiles[j + 1] = pl.tiles[j] + (pl.jobs[j].k / 32) * ((pl.jobs[j].n + 63) / 64);
  }
  pl.total = off;
  return pl;
}

int check_sizes(int n, int s, int position_dim, int direction_dim) {
  if (n < 1 || s < 1) return -1;
  if (s > MAX_RAY_ROWS) return -2;
  if (6 * position_dim > KE || 6 * direction_dim > KD || position_dim < 1 || direction_dim < 1)
    return -3;
  return 0;
}

template <class T>
int launch(const BwdArgs& a, const Plan& pl, float* partial, float* grads, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_kernel<T><<<pl.grid, THREADS, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  WgradArgs w;
  w.scratch = a.scratch;
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
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  reduce_slices<<<(unsigned)((pl.total + 255) / 256), 256, 0, stream>>>(partial, pl.slices,
                                                                         pl.total, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// out = {points, scratch points per channel (padded), slices, gradient
// floats}: the caller allocates scratch [3944, out[1]] in the compute dtype,
// partial [out[2], out[3]] fp32 and grads [out[3]] fp32. Returns 0, or the
// negative codes of fused_raymarch_bwd for sizes it does not take.
extern "C" int fused_raymarch_bwd_sizes(int n, int s, long long* out) {
  const int rc = check_sizes(n, s, 1, 1);
  if (rc != 0) return rc;
  const Plan pl = make_plan(n, s);
  out[0] = pl.p;
  out[1] = pl.pal;
  out[2] = pl.slices;
  out[3] = pl.total;
  return 0;
}

// Writes the 22 gradients into grads (the blocks of GRAD_BLOCKS). Returns 0
// on success, a cudaError_t value if a launch failed, or a negative code for
// arguments the kernel does not take (-1 sizes, -2 S above the per-CTA
// sample buffer, -3 encoding wider than its padded slot).
extern "C" int fused_raymarch_bwd(const void* o, const void* d, const void* ts,
                                  const void* dcolor, const void* dweights, int n, int s,
                                  int position_dim, int direction_dim, int is_bf16,
                                  const void* ws, const void* bs, const void* wts, void* scratch,
                                  void* partial, void* grads, void* stream) {
  const int rc = check_sizes(n, s, position_dim, direction_dim);
  if (rc != 0) return rc;
  const Plan pl = make_plan(n, s);
  BwdArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.ts = static_cast<const float*>(ts);
  a.n = n;
  a.s = s;
  a.rays_per_cta = pl.rays;
  a.pos_ch = 6 * position_dim;
  a.dir_ch = 6 * direction_dim;
  const void* const* wp = static_cast<const void* const*>(ws);
  const float* const* bp = static_cast<const float* const*>(bs);
  const void* const* tp = static_cast<const void* const*>(wts);
  for (int i = 0; i < 12; ++i) a.w[i] = wp[i];
  for (int i = 0; i < 10; ++i) a.b[i] = bp[i];
  for (int i = 0; i < 7; ++i) a.wt[i] = tp[i];
  a.dcolor = static_cast<const float*>(dcolor);
  a.dweights = static_cast<const float*>(dweights);
  a.scratch = scratch;
  a.pal = pl.pal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  return is_bf16 ? launch<__nv_bfloat16>(a, pl, part, out, st) : launch<float>(a, pl, part, out, st);
}
