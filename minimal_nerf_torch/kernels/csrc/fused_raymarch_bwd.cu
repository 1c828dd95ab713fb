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
//   A  `fused_bwd_kernel`: one CTA per group of whole rays, as the forward.
//      It recomputes the forward tile by tile, keeping each layer's input
//      activation (e, ed, a0..a5, h, r0) in the scratch and each ReLU
//      layer's mask as bits (208 B per point) in a device buffer: the CTA
//      holds up to 1,024 rows, whose bits (208 KB) do not fit beside its
//      buffers, while one tile's (26.6 KB) fit in its encoding buffers,
//      which the reverse sweep no longer needs. It then runs the
//      compositing backward per ray (one warp, shuffle scans for the prefix
//      and the suffix sums) and the reverse sweep tile by tile on the tensor
//      cores (the wrapper packs W^T in mma fragment order), each tile first
//      bringing its mask words back into shared memory (mostly from L2: the
//      CTA wrote them moments before), so no epilogue reads device memory
//      per element. It keeps each layer's output gradient (g_a0..g_a5, g_h,
//      g_r0, and g_sigpre | g_rgbpre in one 8-channel block), rounded to the
//      compute dtype. The scratch holds
//      3,944 channels per point in the compute dtype (7,888 B in bf16), each
//      layer's block its own matrix [points, width], so a tile's rows of one
//      layer are one contiguous run. Each layer's tile leaves shared memory
//      as 16-byte streaming stores spread over the k-steps of the next
//      layer, which reads the same tile, so the bytes drain while the
//      tensor cores work. Every dense layer gives
//      each warp all 128 rows of 1/8 of the columns, so a weight fragment
//      crosses from L2 once per tile.
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
// about 4.9 ms at 3.35 TB/s. Kernel A is held by its dense layers on
// mma.sync (weights streamed from L2 one k-step ahead), kernel B by the
// wait for its operand tiles (see mlp_wgrad.cuh).
// Ragged edges: rays past N take zero cotangents, so they add exact zeros;
// rows past a CTA's last sample are never stored; kernel B reads points past
// the end as zeros.

#include "mlp_wgrad.cuh"

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

template <class T>
int launch(const BwdArgs& a, const Plan& pl, float* partial, float* grads, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.n + a.rays_per_cta - 1) / a.rays_per_cta;
  fused_bwd_kernel<T><<<grid, THREADS, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rc = launch_wgrad<T>(pl, a.scratch, partial, grads, a.bias_partial, stream);
  if (rc != 0) return rc;
  return launch_reduce_rows(a.bias_partial, pl.slices, BIAS_CH, grads + pl.total, stream);
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
// its padded slot).
extern "C" int fused_raymarch_bwd(const void* o, const void* d, const void* ts,
                                  const void* dcolor, const void* dweights, int n, int s,
                                  int position_dim, int direction_dim, int is_bf16,
                                  const void* ws, const void* bs, const void* wts, void* scratch,
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
  return is_bf16 ? launch<__nv_bfloat16>(a, pl, part, out, st) : launch<float>(a, pl, part, out, st);
}
