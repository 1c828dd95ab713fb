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
// their order. So the work is split in launches, none of which uses atomics,
// and two launches on the same inputs give bit-identical results:
//   A  one CTA per group of whole rays, as the forward: it recomputes the
//      forward tile by tile, keeping each layer's input activation (e, ed,
//      a0..a5, h, r0) in the scratch and each ReLU layer's mask as bits
//      (208 B per point) in a device buffer (a CTA holds up to 1,024 rows,
//      whose bits do not fit beside its buffers); then the compositing
//      backward per ray (one warp, shuffle scans for the prefix and the
//      suffix sums); then the reverse sweep tile by tile, keeping each
//      layer's output gradient (g_r0, g_h, g_a5..g_a0, and g_sigpre |
//      g_rgbpre in one 8-channel block), rounded to the compute dtype. The
//      scratch holds 3,944 channels per point in the compute dtype (7,888 B
//      in bf16), each layer's block its own matrix [points, width], so a
//      tile's rows of one layer are one contiguous run.
//      bf16: `fused_bwd_kernel_sm90` (mlp_bwd_sm90.cuh), a persistent CTA per
//      SM: every dense layer of both phases on wgmma with TMA-staged weights
//      (the forward's tensor maps, and W [K_in, N_out] itself for the
//      reverse's products with W^T), two consumer warpgroups of 64 rows whose
//      layer outputs stay in registers as the next layer's A operand; each
//      warp's rows leave through a staging buffer of its own (stmatrix, then
//      16-byte streaming stores), the masks as words formed in registers; the
//      reverse's mask words prefetched by cp.async; the producer
//      warpgroup's thread 0 loads the slabs of both phases in order, its
//      warps 1-3 encode the next tile and store the encodings.
//      fp32 (the comparison path): `fused_bwd_kernel`, 8 warps on the FMA
//      units over 64-row tiles in shared-memory ping-pong buffers (the
//      forward's mlp_forward<float, true> and reverse_sweep<float> of
//      fused_raymarch_common.cuh), each tile's mask words brought back into
//      shared memory before its reverse sweep.
//   B  `wgrad_*_kernel` (mlp_wgrad.cuh): for every layer, out[k, n] =
//      sum_p X[p, k] G[p, n] over fixed slices of the points, a tiled GEMM
//      with cp.async-staged operand tiles and ldmatrix fragments (FMA in
//      fp32). Each slice writes its own partial sums. The CTAs of the first
//      row tile of one product per gradient block also sum its columns from
//      the staged tiles: the bias gradients, sums of the bf16-ROUNDED
//      gradients as the scratch holds them (the TPU kernel's bias rounding
//      point), per slice, off the tensor cores and in B's shadow.
//   R  `reduce_slices` adds the slices' partial sums in a fixed order,
//      `reduce_rows` the slices' bias sums (mlp_wgrad.cuh).
//
// What bounds it: tensor-core operations, 1,347,456 multiply-adds per point
// (forward recomputed, activation gradients, weight gradients), against
// 7,888 B of scratch (and 208 B of mask bits) written and read per point in
// bf16: the operations bound is 2.86 ms per 4096-ray step at 64 + 192
// samples, the bytes of a design that keeps the scratch in device memory
// about 4.9 ms at 3.35 TB/s. Kernel A's own floor is its stores, 8,096 B a
// point (2.42 ns at 3.35 TB/s), beside its 887,040 multiply-adds (1.79 ns at
// 989 TFLOP/s); kernel B is held by the wait for its operand tiles (see
// mlp_wgrad.cuh).
// Ragged edges: rays past N take zero cotangents, so they add exact zeros;
// rows past a CTA's last sample are never stored; kernel B reads points past
// the end as zeros.

#include "mlp_bwd_sm90.cuh"

namespace {

struct BwdArgs : RayArgs {
  const float* dcolor;
  const float* dweights;  // may be null: zeros
  const void* wt[7];
  void* scratch;          // Scratch of `points` points
  long long points;
  uint32_t* masks;        // [points][MASK_WORDS]
  float* bias_partial;    // [slices][BIAS_CH], written by kernel B
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
  // free during the reverse sweep: E and D hold a tile's mask words
  uint32_t* mk = reinterpret_cast<uint32_t*>(E);
  static_assert(sizeof(uint32_t) * M * MASK_WORDS <= sizeof(T) * M * (LDE + LDD), "mask words");

  const Scratch<T> sc{static_cast<T*>(a.scratch), a.points};
  const int ray0 = blockIdx.x * a.rays_per_cta;
  const int rows_total = a.rays_per_cta * a.s;
  const long long cta_p0 = (long long)blockIdx.x * rows_total;
  uint32_t* masks = a.masks + cta_p0 * MASK_WORDS;

  // 1. the forward, keeping every layer's input and the ReLU masks
  encode_dirs<T>(a, ray0, dray, LDD);
  __syncthreads();
  for (int row_base = 0; row_base < rows_total; row_base += M) {
    encode_tile<T>(a, ray0, row_base, E, LDE, D, dray, LDD, xs, rayl);
    __syncthreads();
    mlp_forward<T, true>(a, E, D, P, Q, sc, cta_p0 + row_base, min(M, rows_total - row_base),
                         masks + (long long)row_base * MASK_WORDS);
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

  // 3. the reverse sweep, tile by tile: the tile's mask words back in shared
  // memory, then every layer's output gradient (kernel B sums them)
  for (int row_base = 0; row_base < rows_total; row_base += M) {
    const int rows = min(M, rows_total - row_base);
    const uint4* src = reinterpret_cast<const uint4*>(masks + (long long)row_base * MASK_WORDS);
    for (int i = threadIdx.x; i < rows * MASK_WORDS / 4; i += THREADS)
      reinterpret_cast<uint4*>(mk)[i] = src[i];
    __syncthreads();
    reverse_sweep<T>(a, a.wt, P, Q, sc, cta_p0 + row_base, rows, sig + row_base,
                     rgb + row_base * 3, mk);
  }
}

// the plan of one backward: every product of JOB_TABLE over the points of
// whole CTAs (rays past N give zero rows)
Plan ray_plan(int n, int s) {
  const int rays = rays_per_cta(s), grid = (n + rays - 1) / rays;
  return make_plan((long long)grid * rays * s);
}

int check_sizes(int n, int s, int position_dim, int direction_dim) {
  if (n < 1 || s < 1) return -1;
  if (s > MAX_RAY_ROWS) return -2;
  if (6 * position_dim > KE || 6 * direction_dim > KD || position_dim < 1 || direction_dim < 1)
    return -3;
  return 0;
}

// kernel A of the fp32 backward (the bf16 one is fused_bwd_kernel_sm90)
int launch_a(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<float>();
  const cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.n + a.rays_per_cta - 1) / a.rays_per_cta;
  fused_bwd_kernel<float><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, sm_90a

struct alignas(64) BwdSm90Params {
  WeightMaps maps;  // the forward's matrices (mlp_fwd_sm90_maps)
  RevMaps rev;      // the reverse's (fused_raymarch_bwd_maps)
  BwdArgs a;
};

// the encoders' share of a group at ray0: each ray's direction encoding
// once (encode_dirs on ENC_THREADS threads)
__device__ __forceinline__ void encode_dirs_bw(const BwdArgs& a, int ray0, __nv_bfloat16* dray,
                                               int tid) {
  for (int idx = tid; idx < a.rays_per_cta * (KD / 2); idx += ENC_THREADS) {
    const int rl = idx / (KD / 2), p = idx % (KD / 2);
    const float* dv = a.d + min(ray0 + rl, a.n - 1) * 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
                               __fmul_rn(dv[2], dv[2]));
    encode_pair<__nv_bfloat16>(dray + rl * LDD_BW, p, a.dir_ch / 2, a.dir_ch,
                               __fmul_rn(dv[p % 3], rsqrtf(ss)));
  }
}

// the encoders' share of a tile, as encode_tile_sw of fused_raymarch_fwd.cu:
// its 128 rows from row_base of the group at ray0, E and D sw128, the rows
// of consumer warpgroup r / 64 in its own pair
__device__ __forceinline__ void encode_tile_bw(const BwdArgs& a, int ray0, int row_base,
                                               const BwdSmem& sm, int tid) {
  float* xs = sm.xs();
  int* rayl = sm.rayl();
  const __nv_bfloat16* dray = sm.dray();
  for (int r = tid; r < TILE_ROWS; r += ENC_THREADS) {
    const int row = row_base + r, rl = row / a.s;
    const int ray = min(ray0 + rl, a.n - 1);  // rows past the end: any valid ray
    const float t = a.ts[(size_t)ray * a.s + (row - rl * a.s)];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      xs[r * 3 + k] = __fmul_rn(__fadd_rn(a.o[ray * 3 + k], __fmul_rn(t, a.d[ray * 3 + k])),
                                INV_PI);
    rayl[r] = min(rl, a.rays_per_cta - 1);
  }
  named_sync(BAR_ENCODERS, ENC_THREADS);
  for (int idx = tid; idx < TILE_ROWS * (KC / 2); idx += ENC_THREADS) {
    const int r = idx / (KC / 2), p = idx % (KC / 2);
    encode_pair_sw(sm.enc(r / WG_ROWS), r % WG_ROWS, p, a.pos_ch / 2, a.pos_ch,
                   xs[r * 3 + p % 3]);
  }
  for (int idx = tid; idx < TILE_ROWS * (KC / 8); idx += ENC_THREADS) {
    const int r = idx / (KC / 8), c = idx % (KC / 8), rr = r % WG_ROWS;  // 16-byte piece c
    const uint4 v = c < KD / 8 ? *reinterpret_cast<const uint4*>(dray + rayl[r] * LDD_BW + c * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sm.dir(r / WG_ROWS) + rr * 128 + ((c ^ (rr & 7)) << 4)) = v;
  }
}

// rows [0, rows) of the tile's encodings to the scratch's e and ed blocks
// from point p0 (16-byte pieces 0-7 of E, 0-3 of D)
__device__ __forceinline__ void keep_encodings(const BwdSmem& sm,
                                               const Scratch<__nv_bfloat16>& sc, long long p0,
                                               int rows, int tid) {
  constexpr int PIECES = KE / 8 + KD / 8;
  for (int idx = tid; idx < rows * PIECES; idx += ENC_THREADS) {
    const int r = idx / PIECES, c = idx % PIECES, rr = r % WG_ROWS;
    const bool pos = c < KE / 8;
    const int pc = pos ? c : c - KE / 8;
    const unsigned char* src = (pos ? sm.enc(r / WG_ROWS) : sm.dir(r / WG_ROWS)) +
                               rr * 128 + ((pc ^ (rr & 7)) << 4);
    __nv_bfloat16* dst = pos ? sc.row(C_E, KE, p0 + r) : sc.row(C_ED, KD, p0 + r);
    __stcs(reinterpret_cast<uint4*>(dst) + pc, *reinterpret_cast<const uint4*>(src));
  }
}

// the heads of a warpgroup's rows into the CTA's sample buffers
struct HeadOut {
  float* sig_buf;
  float* rgb_buf;
  int row0, rows_total;
  __device__ __forceinline__ void sigma(int r, float v) const {
    if (row0 + r < rows_total) sig_buf[row0 + r] = v;
  }
  __device__ __forceinline__ void rgb(int r, float c0, float c1, float c2) const {
    if (row0 + r < rows_total) {
      float* o = rgb_buf + (row0 + r) * 3;
      o[0] = c0;
      o[1] = c1;
      o[2] = c2;
    }
  }
};

// Kernel A of the bf16 backward: a persistent CTA per SM walks ray groups
// (as fused_fwd_sm90 does); for each, the forward of its tiles keeping the
// scratch and the masks (mlp_rows_keep), the compositing backward per ray
// (composite_ray_bwd, one consumer warp a ray), then the reverse sweep of
// its tiles (reverse_rows). The producer warpgroup's thread 0 loads the
// weight slabs of both phases in order; its warps 1-3 encode.
__global__ void __launch_bounds__(SM90_THREADS, 1)
    fused_bwd_kernel_sm90(const __grid_constant__ BwdSm90Params prm) {
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem sm = bwd_setup(smem_raw);
  const BwdArgs& a = prm.a;
  const int groups = (a.n + a.rays_per_cta - 1) / a.rays_per_cta;
  const int rows_total = a.rays_per_cta * a.s;
  const int tiles = (rows_total + TILE_ROWS - 1) / TILE_ROWS;
  const int iters = persistent_iters(groups);
  const Scratch<__nv_bfloat16> sc{static_cast<__nv_bfloat16*>(a.scratch), a.points};
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMER_WGS) {
    producer_setup();
    const int tid = threadIdx.x % WG_THREADS;
    if (tid == 0) {
      produce_bwd(prm.maps, prm.rev, sm, iters, tiles);
    } else if (tid >= 32) {  // the encoders, a group (past n: all masked) at a time
      EncBuf eb{sm.enc_bars(), 0};
      for (int it = 0; it < iters; ++it) {
        const int group = blockIdx.x + it * gridDim.x, ray0 = group * a.rays_per_cta;
        const long long cta_p0 = (long long)group * rows_total;
        named_sync(BAR_ENCODERS, ENC_THREADS);  // the last group's D copies read dray
        encode_dirs_bw(a, ray0, sm.dray(), tid - 32);
        for (int row_base = 0; row_base < rows_total; row_base += TILE_ROWS) {
          eb.acquire();
          named_sync(BAR_ENCODERS, ENC_THREADS);  // dray written; the last tile read xs, rayl
          encode_tile_bw(a, ray0, row_base, sm, tid - 32);
          eb.publish();
          named_sync(BAR_ENCODERS, ENC_THREADS);  // every encoder's rows are in
          keep_encodings(sm, sc, cta_p0 + row_base, min(TILE_ROWS, rows_total - row_base),
                         tid - 32);
        }
      }
    }
  } else {
    consumer_setup();
    BwRing ring{saddr(sm.base), sm.bars(), 0, 0};
    EncBuf eb{sm.enc_bars(), 0};
    const int warp = threadIdx.x >> 5, wi = warp % (WG_THREADS / 32);
    float* sig = sm.sig();
    float* rgb = sm.rgb();
    for (int it = 0; it < iters; ++it) {
      const int group = blockIdx.x + it * gridDim.x, ray0 = group * a.rays_per_cta;
      const long long cta_p0 = (long long)group * rows_total;
      // where this warp keeps rows [row0 + 16 wi, + 16) of a tile
      auto keep_at = [&](int row0) {
        const int r0 = row0 + wi * WARP_ROWS;
        const long long p = cta_p0 + r0;
        return WarpKeep{sc, p, max(0, min(WARP_ROWS, rows_total - r0)), a.masks + p * MASK_WORDS,
                        sm.stg(warp), sm.mbuf(warp)};
      };
      named_sync(BAR_CONSUMERS, CONSUMER_WGS * WG_THREADS);  // the last reverse read sig, rgb
      // 1. the forward, keeping every layer's input and the ReLU masks
      for (int row_base = 0; row_base < rows_total; row_base += TILE_ROWS) {
        const int row0 = row_base + wg * WG_ROWS;
        eb.wait();
        mlp_rows_keep(a, ring, sm.enc(wg), sm.dir(wg),
                      HeadOut{sig, rgb, row0, rows_total}, keep_at(row0));
        eb.release();
      }
      named_sync(BAR_CONSUMERS, CONSUMER_WGS * WG_THREADS);  // every row's heads are in
      // 2. compositing backward: sig <- g_sigpre, rgb <- g_rgbpre; rays past
      // N take zero cotangents
      float* wgt = reinterpret_cast<float*>(sm.stg(0));
      float* aa = wgt + MAX_RAY_ROWS;
      const int lane = threadIdx.x & 31;
      for (int r = warp; r < a.rays_per_cta; r += CONSUMER_WARPS) {
        const int ray = ray0 + r;
        float* rs = sig + r * a.s;
        float* rr = rgb + r * a.s * 3;
        if (ray < a.n) {
          composite_ray_bwd<__nv_bfloat16>(a, ray, rs, rr, wgt + r * a.s, aa + r * a.s);
        } else {
          for (int i = lane; i < a.s; i += 32) rs[i] = rr[i * 3] = rr[i * 3 + 1] = rr[i * 3 + 2] = 0.f;
        }
      }
      named_sync(BAR_CONSUMERS, CONSUMER_WGS * WG_THREADS);  // gradients in, staging free
      // 3. the reverse sweep, tile by tile
      for (int row_base = 0; row_base < rows_total; row_base += TILE_ROWS) {
        const int row0 = row_base + wg * WG_ROWS;
        reverse_rows(a, ring, sc, cta_p0 + row0, max(0, min(WG_ROWS, rows_total - row0)),
                     sig + row0, rgb + row0 * 3, keep_at(row0));
      }
    }
  }
}

int launch_sm90(const BwdArgs& a, const void* maps, const void* rev, cudaStream_t stream) {
  BwdSm90Params prm;
  memcpy(&prm.maps, maps, sizeof(WeightMaps));
  memcpy(&prm.rev, rev, sizeof(RevMaps));
  prm.a = a;
  return launch_persistent(fused_bwd_kernel_sm90, prm, (a.n + a.rays_per_cta - 1) / a.rays_per_cta,
                           BWD_SM90_SMEM, stream);
}

}  // namespace

// out = {points, slices, weight-gradient floats, bias-sum rows (the slices),
// bias floats (1928), mask words per point (52), scratch channels per point
// (3944)}: the caller allocates scratch [out[0] * out[6]] in the compute
// dtype, masks [out[0], out[5]] int32, partial [out[1], out[2]] fp32,
// bias_partial [out[3], out[4]] fp32 and grads [out[2] + out[4]] fp32.
// Returns 0, or the negative codes of fused_raymarch_bwd for sizes it does
// not take.
extern "C" int fused_raymarch_bwd_sizes(int n, int s, long long* out) {
  const int rc = check_sizes(n, s, 1, 1);
  if (rc != 0) return rc;
  const Plan pl = ray_plan(n, s);
  out[0] = pl.p;
  out[1] = pl.slices;
  out[2] = pl.total;
  out[3] = pl.slices;
  out[4] = BIAS_CH;
  out[5] = MASK_WORDS;
  out[6] = CHANNELS;
  return 0;
}

// Writes the 12 weight gradients (the weight blocks of GRAD_BLOCKS), then
// the 1,928 bias sums in scratch channel order (g_a0..g_a5, g_h, g_r0, the
// heads' block), into grads. Returns 0 on success, a cudaError_t value if a
// launch failed, or a negative code for arguments the kernel does not take
// (-1 sizes, -2 S above the per-CTA sample buffer, -3 encoding wider than
// its padded slot, -4 bf16 without tensor maps). bf16 reads the forward's
// weights through maps (mlp_fwd_sm90_maps), the reverse's through rev_maps
// (fused_raymarch_bwd_maps), and of ws only the heads' (DW, R1); fp32 reads
// ws and wts.
extern "C" int fused_raymarch_bwd(const void* o, const void* d, const void* ts,
                                  const void* dcolor, const void* dweights, int n, int s,
                                  int position_dim, int direction_dim, int is_bf16,
                                  const void* ws, const void* bs, const void* wts,
                                  const void* maps, const void* rev_maps, void* scratch,
                                  void* masks, void* partial, void* bias_partial, void* grads,
                                  void* stream) {
  const int rc = check_sizes(n, s, position_dim, direction_dim);
  if (rc != 0) return rc;
  const Plan pl = ray_plan(n, s);
  BwdArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.ts = static_cast<const float*>(ts);
  a.n = n;
  a.s = s;
  a.rays_per_cta = rays_per_cta(s);
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
  a.points = pl.p;
  a.masks = static_cast<uint32_t*>(masks);
  a.bias_partial = static_cast<float*>(bias_partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  if (is_bf16 && (maps == nullptr || rev_maps == nullptr)) return -4;
  int err = is_bf16 ? launch_sm90(a, maps, rev_maps, st) : launch_a(a, st);
  if (err != 0) return err;
  err = is_bf16 ? launch_wgrad<__nv_bfloat16>(pl, a.scratch, part, out, a.bias_partial, st)
                : launch_wgrad<float>(pl, a.scratch, part, out, a.bias_partial, st);
  if (err != 0) return err;
  return launch_reduce_rows(a.bias_partial, pl.slices, BIAS_CH, out + pl.total, st);
}
