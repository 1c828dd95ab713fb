// Point-level NeRF MLP backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nerf_mlp_bwd_kernel` of
// minimal_nerf_tpu/kernels/raymarch.py (launched by `_pallas_points_backward`,
// the custom VJP of `_pallas_apply_core`). From x, d [P, 3] and the
// cotangents dsig [P, 1], drgb [P, 3] it computes the 12 weight gradients and
// 10 bias gradients of the MLP, fp32, summed over all points:
//   * the forward again (raymarch_mlp_fwd.cu's code, so the same rounding);
//   * g_rgbpre = drgb * rgb * (1 - rgb) and g_sigpre = dsig * [sigma > 0];
//   * the reverse sweep through the heads and the trunk (products with W^T),
//     each gradient masked by its ReLU;
//   * every weight gradient A^T G and every bias gradient.
//
// Numerics follow `_nerf_mlp_bwd_kernel`, whose rounding points differ from
// the fused backward's in one place: every gradient enters a product
// rounded to the compute dtype (as its operand), but the bias gradients are
// fp32 sums of the UNROUNDED gradients (`jnp.sum(g_a0, 0)`).
//
// Design (the fused backward's, fused_raymarch_bwd.cu, without rays):
//   A  `points_bwd_kernel`: one CTA per tile of points (128 in bf16, 64 in
//      fp32). It recomputes the forward, keeping each layer's input, forms
//      the heads' gradients, then runs the reverse sweep, keeping each
//      layer's output gradient (rounded to the compute dtype, as the
//      products read it) in the feature-major scratch [3,944 channels,
//      point], 7,888 B per point in bf16. While the sweep stores a gradient
//      it also sums each column of the tile in fp32 before the rounding (in
//      the dense layers' epilogue: per warp with shuffles, then in a fixed
//      order across warps) and writes the tile's 1,928 bias sums to its own
//      row of a per-CTA buffer.
//   B  `wgrad_*_kernel` and R `reduce_slices` (mlp_wgrad.cuh): the 12
//      weight products over fixed slices of the points, then the slices
//      added in a fixed order.
//   R' `reduce_slices` again: the CTAs' bias sums added in CTA order.
// No atomics: two launches on the same inputs give bit-identical results.
//
// What bounds it: tensor-core operations, 1,347,456 multiply-adds per point
// (forward recomputed, activation gradients, weight gradients), against
// ~16 KB of scratch written and read per point in bf16. Ragged edges: rows
// past P are never stored and add zeros to every sum; kernel B reads points
// past P as zeros.

#include "mlp_wgrad.cuh"

namespace {

struct PointBwdArgs : PointArgs {
  const float* dsig;
  const float* drgb;
  const void* wt[7];
  void* scratch;
  long long pal;       // points per scratch channel (padded)
  float* bias_partial;  // [CTAs][BIAS_CH]
};

// the forward's buffers, the tile's head values / gradients sig [M] and
// rgb [M, 3], and the bias sums' partial rows [SUM_ROWS][BIAS_CH]
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD)) +
         sizeof(float) * 4 * M + sizeof(float) * Tile<T>::SUM_ROWS * BIAS_CH;
}

template <class T>
__global__ void __launch_bounds__(THREADS) points_bwd_kernel(PointBwdArgs a) {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD, SUM_ROWS = Tile<T>::SUM_ROWS;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  T* Q = P + M * LDW;
  T* E = Q + M * LDW;
  T* D = E + M * LDE;
  float* sig = reinterpret_cast<float*>(D + M * LDD);
  float* rgb = sig + M;
  float* bsum = rgb + 3 * M;

  T* sc = static_cast<T*>(a.scratch);
  const long long p0 = (long long)blockIdx.x * M;
  const int rows = (int)min((long long)M, a.p - p0);
  // partial rows that no dense layer writes (the head block, g_r0's rows
  // past the first two) stay zero
  for (int i = threadIdx.x; i < SUM_ROWS * BIAS_CH; i += THREADS) bsum[i] = 0.f;

  // 1. the forward, keeping every layer's input
  encode_points<T>(a, p0, E, LDE, D, LDD);
  __syncthreads();
  mlp_forward<T, true>(a, E, D, P, Q, sc, a.pal, p0, rows);
  heads<T>(a, P, Q, LDW, 0, rows, sig, rgb);
  __syncthreads();

  // 2. the heads' gradients in fp32, zero past P
  for (int r = threadIdx.x; r < M; r += THREADS) {
    const bool in = r < rows;
    sig[r] = in && sig[r] > 0.f ? a.dsig[p0 + r] : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c = rgb[r * 3 + k];
      rgb[r * 3 + k] = in ? __fmul_rn(__fmul_rn(a.drgb[(p0 + r) * 3 + k], c), __fsub_rn(1.f, c))
                          : 0.f;
    }
  }
  __syncthreads();
  // their column sums (warp k < 4: column k of the head block), then the
  // rounding the products read
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    float s = 0.f;
    for (int r = lane; r < M; r += 32) s += warp == 0 ? sig[r] : rgb[r * 3 + warp - 1];
    s = warp_sum(s);
    if (lane == 0) bsum[C_HEAD - C_GA0 + warp] = s;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < M; r += THREADS) {
    sig[r] = tof(fromf<T>(sig[r]));
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[r * 3 + k] = tof(fromf<T>(rgb[r * 3 + k]));
  }
  __syncthreads();

  // 3. the reverse sweep, keeping every layer's output gradient and its
  // unrounded column sums
  reverse_sweep<T, true>(a, a.wt, P, Q, sc, a.pal, p0, rows, sig, rgb, bsum);

  // 4. the tile's bias sums, the partial rows added in order
  float* out = a.bias_partial + (long long)blockIdx.x * BIAS_CH;
  for (int i = threadIdx.x; i < BIAS_CH; i += THREADS) {
    float s = bsum[i];
#pragma unroll
    for (int k = 1; k < SUM_ROWS; ++k) s += bsum[k * BIAS_CH + i];
    out[i] = s;
  }
}

int check_sizes(long long p, int position_dim, int direction_dim) {
  if (p < 1) return -1;
  if (6 * position_dim > KE || 6 * direction_dim > KD || position_dim < 1 || direction_dim < 1)
    return -3;
  return 0;
}

template <class T>
long long ctas(long long p) {
  return (p + Tile<T>::M - 1) / Tile<T>::M;
}

template <class T>
int launch(const PointBwdArgs& a, const Plan& pl, float* partial, float* grads,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      points_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = ctas<T>(a.p);
  points_bwd_kernel<T><<<(unsigned)grid, THREADS, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rc = launch_wgrad<T>(pl, a.scratch, partial, grads, stream);
  if (rc != 0) return rc;
  reduce_slices<<<(BIAS_CH + 255) / 256, 256, 0, stream>>>(a.bias_partial, (int)grid, BIAS_CH,
                                                           grads + pl.total);
  return (int)cudaGetLastError();
}

}  // namespace

// out = {scratch points per channel (padded), slices, weight-gradient
// floats, CTAs, bias floats (1928)}: the caller allocates scratch
// [3944, out[0]] in the compute dtype, partial [out[1], out[2]] fp32,
// bias_partial [out[3], out[4]] fp32 and grads [out[2] + out[4]] fp32.
// Returns 0, or -1 for p < 1.
extern "C" int raymarch_mlp_bwd_sizes(int p, int is_bf16, long long* out) {
  const int rc = check_sizes(p, 1, 1);
  if (rc != 0) return rc;
  const Plan pl = make_plan(p, WEIGHT_JOBS);
  out[0] = pl.pal;
  out[1] = pl.slices;
  out[2] = pl.total;
  out[3] = is_bf16 ? ctas<__nv_bfloat16>(p) : ctas<float>(p);
  out[4] = BIAS_CH;
  return 0;
}

// Writes the 12 weight gradients (the first 12 blocks of GRAD_BLOCKS), then
// the 1,928 bias sums in scratch channel order (g_a0..g_a5, g_h, g_r0, the
// heads' block), into grads. Returns 0 on success, a cudaError_t value if a
// launch failed, or a negative code for arguments the kernel does not take
// (-1 sizes, -3 encoding wider than its padded slot).
extern "C" int raymarch_mlp_bwd(const void* x, const void* d, const void* dsig,
                                const void* drgb, int p, int position_dim, int direction_dim,
                                int is_bf16, const void* ws, const void* bs, const void* wts,
                                void* scratch, void* partial, void* bias_partial, void* grads,
                                void* stream) {
  const int rc = check_sizes(p, position_dim, direction_dim);
  if (rc != 0) return rc;
  const Plan pl = make_plan(p, WEIGHT_JOBS);
  PointBwdArgs a;
  a.x = static_cast<const float*>(x);
  a.dir = static_cast<const float*>(d);
  a.p = p;
  a.pos_ch = 6 * position_dim;
  a.dir_ch = 6 * direction_dim;
  const void* const* wp = static_cast<const void* const*>(ws);
  const float* const* bp = static_cast<const float* const*>(bs);
  const void* const* tp = static_cast<const void* const*>(wts);
  for (int i = 0; i < 12; ++i) a.w[i] = wp[i];
  for (int i = 0; i < 10; ++i) a.b[i] = bp[i];
  for (int i = 0; i < 7; ++i) a.wt[i] = tp[i];
  a.dsig = static_cast<const float*>(dsig);
  a.drgb = static_cast<const float*>(drgb);
  a.scratch = scratch;
  a.pal = pl.pal;
  a.bias_partial = static_cast<float*>(bias_partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  return is_bf16 ? launch<__nv_bfloat16>(a, pl, part, out, st) : launch<float>(a, pl, part, out, st);
}
