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
//      fp32). It recomputes the forward, keeping each layer's input in the
//      scratch (3,944 channels, 7,888 B per point in bf16, one matrix per
//      layer, stored while the next layer's products run) and each
//      ReLU layer's mask as bits in shared memory (26.6 KB for the tile),
//      forms the heads' gradients, then runs the reverse sweep, keeping each
//      layer's output gradient (rounded to the compute dtype, as the
//      products read it). The masks never leave the CTA: no epilogue reads
//      device memory. While the sweep stores a gradient it also sums each
//      column of the tile in fp32 before the rounding (in the dense layers'
//      epilogue, within the warp that owns the column) and writes the
//      tile's 1,928 bias sums to its own row of a per-CTA buffer.
//   B  `wgrad_*_kernel` and R `reduce_slices` (mlp_wgrad.cuh): the 12
//      weight products over fixed slices of the points (a tiled GEMM with
//      cp.async-staged operand tiles in bf16), then the slices added in a
//      fixed order.
//   R' `reduce_rows`: the CTAs' bias sums added in a fixed order.
// No atomics: two launches on the same inputs give bit-identical results.
//
// What bounds it: tensor-core operations, 1,347,456 multiply-adds per point
// (forward recomputed, activation gradients, weight gradients), against
// 7,888 B of scratch written and read per point in bf16. Ragged edges: rows
// past P are never stored and add zeros to every sum; kernel B reads points
// past P as zeros.

#include "mlp_wgrad.cuh"

namespace {

struct PointBwdArgs : PointArgs {
  const float* dsig;
  const float* drgb;
  const void* wt[7];
  void* scratch;        // Scratch of p points
  float* bias_partial;  // [CTAs][BIAS_CH]
};

// bsum[C_HEAD - C_GA0 + k] += the sum over rows [0, rows) of the heads'
// gradient column k (k = 0: gsig, 1..3: grgb [rows, 3]); warp k sums column k
__device__ __forceinline__ void head_sums(const float* gsig, const float* grgb, int rows,
                                          float* bsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) s += warp == 0 ? gsig[r] : grgb[r * 3 + warp - 1];
    s = warp_sum(s);
    if (lane == 0) bsum[C_HEAD - C_GA0 + warp] += s;
  }
}

// the forward's buffers, the tile's head values / gradients sig [M] and
// rgb [M, 3], the bias sums [BIAS_CH], the dense layers' partial column
// sums [SUM_ROWS][WIDTH] and the tile's mask words [M][MASK_WORDS]
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD)) +
         sizeof(float) * (4 * M + BIAS_CH + Tile<T>::SUM_ROWS * WIDTH) +
         sizeof(uint32_t) * M * MASK_WORDS;
}

template <class T>
__global__ void __launch_bounds__(THREADS) points_bwd_kernel(PointBwdArgs a) {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  T* Q = P + M * LDW;
  T* E = Q + M * LDW;
  T* D = E + M * LDE;
  float* sig = reinterpret_cast<float*>(D + M * LDD);
  float* rgb = sig + M;
  float* bsum = rgb + 3 * M;
  float* red = bsum + BIAS_CH;
  uint32_t* mk = reinterpret_cast<uint32_t*>(red + Tile<T>::SUM_ROWS * WIDTH);

  const Scratch<T> sc{static_cast<T*>(a.scratch), a.p};
  const long long p0 = (long long)blockIdx.x * M;
  const int rows = (int)min((long long)M, a.p - p0);
  for (int i = threadIdx.x; i < BIAS_CH; i += THREADS) bsum[i] = 0.f;

  // 1. the forward, keeping every layer's input and the ReLU masks
  encode_points<T>(a, p0, E, LDE, D, LDD);
  __syncthreads();
  mlp_forward<T, true>(a, E, D, P, Q, sc, p0, rows, mk);
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
  // their column sums, then the rounding the products read
  head_sums(sig, rgb, rows, bsum);
  __syncthreads();
  for (int r = threadIdx.x; r < M; r += THREADS) {
    sig[r] = tof(fromf<T>(sig[r]));
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[r * 3 + k] = tof(fromf<T>(rgb[r * 3 + k]));
  }
  __syncthreads();

  // 3. the reverse sweep, keeping every layer's output gradient and its
  // unrounded column sums
  reverse_sweep<T, true>(a, a.wt, P, Q, sc, p0, rows, sig, rgb, mk, bsum, red);
  __syncthreads();

  // 4. the tile's bias sums
  float* out = a.bias_partial + (long long)blockIdx.x * BIAS_CH;
  for (int i = threadIdx.x; i < BIAS_CH; i += THREADS) out[i] = bsum[i];
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
  const int rc = launch_wgrad<T>(pl, a.scratch, partial, grads, nullptr, stream);
  if (rc != 0) return rc;
  return launch_reduce_rows(a.bias_partial, grid, BIAS_CH, grads + pl.total, stream);
}

}  // namespace

// out = {scratch points, slices, weight-gradient floats, CTAs, bias floats
// (1928), scratch channels per point (3944)}: the caller allocates scratch
// [out[0] * out[5]] in the compute dtype,
// partial [out[1], out[2]] fp32, bias_partial [out[3], out[4]] fp32 and
// grads [out[2] + out[4]] fp32. Returns 0, or -1 for p < 1.
extern "C" int raymarch_mlp_bwd_sizes(int p, int is_bf16, long long* out) {
  const int rc = check_sizes(p, 1, 1);
  if (rc != 0) return rc;
  const Plan pl = make_plan(p);
  out[0] = pl.p;
  out[1] = pl.slices;
  out[2] = pl.total;
  out[3] = is_bf16 ? ctas<__nv_bfloat16>(p) : ctas<float>(p);
  out[4] = BIAS_CH;
  out[5] = CHANNELS;
  return 0;
}

// Writes the 12 weight gradients (the weight blocks of GRAD_BLOCKS), then
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
  const Plan pl = make_plan(p);
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
  a.bias_partial = static_cast<float*>(bias_partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  return is_bf16 ? launch<__nv_bfloat16>(a, pl, part, out, st) : launch<float>(a, pl, part, out, st);
}
