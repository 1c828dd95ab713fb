// Fused ray-march forward pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_fwd_kernel` of
// minimal_nerf_tpu/kernels/fused_raymarch.py (body `_fused_forward_core`,
// launched by `_fused_forward`). For every ray it computes, without writing
// any per-sample intermediate to device memory:
//   positions x = (o + t*d) / pi and unit directions d * rsqrt(|d|^2),
//   the frequency-major cos-before-sin positional encodings (60 + 24 ch),
//   the 8-layer skip MLP with its density and rgb heads,
//   deltas (terminal 1e10), exclusive-prefix transmittance, the weights and
//   the composited ray color.
// Outputs: color [N, 3] and weights [N, S], both fp32.
//
// Numerics follow `_fused_forward_core`: under bf16 the positions and unit
// directions are rounded to bf16 before the encoding angles are formed; the
// encodings and every ReLU activation (and h) are stored in the compute
// dtype; matmuls accumulate in fp32, biases are added in fp32, sigma/rgb and
// compositing are fp32. The skip and rgb concatenations are split matmuls.
//
// What bounds it: tensor-core operations. Each sample point costs 460,416
// multiply-adds in the MLP, while the pass reads only o, d, ts and ~1 MB of
// bf16 weights and writes color and weights: a 4096-ray chunk at 64 + 192
// samples is ~0.97 TFLOP against a few MB of traffic, far above the card's
// ~295 FLOP/byte ridge.
//
// What the design does about that bound:
//   * One CTA (8 warps) owns a group of whole rays and walks their samples in
//     row tiles (128 rows for bf16, 64 for fp32). The tile's activations stay
//     in shared memory in ping-pong buffers [rows, 256 + pad]; nothing of the
//     MLP touches device memory.
//   * bf16 layers run on the tensor cores with mma.sync.m16n8k16 (fp32
//     accumulate). The wrapper pre-packs every weight matrix in mma fragment
//     order, so a warp streams its B fragments from global memory / L2 as
//     coalesced 8-byte loads, one k-step ahead of the math (register double
//     buffering). Row padding of 8 bf16 keeps the A-fragment loads from
//     shared memory free of bank conflicts.
//   * The fp32 path (used to hold the kernel against the plain version) runs
//     the same structure on the FMA units with [K, N] weights.
//   * The encodings are the other large cost (sincosf's range reduction):
//     each cos/sin pair is one sincosf, the direction encoding is formed
//     once per ray (not per sample), and each tile row's position is formed
//     once before the channel loops.
//   * The density / rgb heads (widths 1 and 3) are warp dot products.
//   * Compositing is one warp per ray: each lane owns a run of consecutive
//     samples and the exclusive prefix of -sigma*delta is a warp-shuffle
//     scan, so no triangular matmul and no padding to multiples of 8.
//   * Ragged edges (rays past N, rows past the last sample) are masked.
// Tried and slower on an H100 (PERF.md): staging each weight k-step in a
// shared-memory cp.async ring with a CTA barrier per k-step.
// wgmma/TMA and warp specialisation are later work.

#include "fused_raymarch_common.cuh"

namespace {

struct FwdArgs : RayArgs {
  float* color;
  float* weights;
};

// activations P, Q [M, 256+pad], encodings E, D [M, ...], per-sample sigma
// and rgb, the per-ray direction encodings [MAX_RAYS, KD+pad], then each
// tile row's position [M, 3] and ray [M]
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD)) +
         sizeof(float) * 4 * MAX_RAY_ROWS + sizeof(T) * MAX_RAYS * (KD + PAD) +
         sizeof(float) * M * 4;
}

// deltas, exclusive-prefix transmittance, weights and color of one ray (one warp)
__device__ void composite_ray(const FwdArgs& a, int ray, const float* sig, const float* rgb) {
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
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float* wout = a.weights + (size_t)ray * s;
  for (int i = lo; i < hi; ++i) {
    const float v = ndd(i);
    const float w = (1.f - expf(v)) * expf(run);
    run += v;
    wout[i] = w;
    c0 = fmaf(w, rgb[i * 3 + 0], c0);
    c1 = fmaf(w, rgb[i * 3 + 1], c1);
    c2 = fmaf(w, rgb[i * 3 + 2], c2);
  }
  c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
  if (lane == 0) {
    a.color[ray * 3 + 0] = c0;
    a.color[ray * 3 + 1] = c1;
    a.color[ray * 3 + 2] = c2;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS) fused_fwd_kernel(FwdArgs a) {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  T* Q = P + M * LDW;
  T* E = Q + M * LDW;
  T* D = E + M * LDE;
  float* sig = reinterpret_cast<float*>(D + M * LDD);
  float* rgb = sig + MAX_RAY_ROWS;
  T* dray = reinterpret_cast<T*>(rgb + 3 * MAX_RAY_ROWS);
  float* xs = reinterpret_cast<float*>(dray + MAX_RAYS * LDD);
  int* rayl = reinterpret_cast<int*>(xs + 3 * M);

  const int ray0 = blockIdx.x * a.rays_per_cta;
  const int rows_total = a.rays_per_cta * a.s;
  encode_dirs<T>(a, ray0, dray, LDD);
  __syncthreads();
  for (int row_base = 0; row_base < rows_total; row_base += M) {
    encode_tile<T>(a, ray0, row_base, E, LDE, D, dray, LDD, xs, rayl);
    __syncthreads();
    mlp_forward<T>(a, E, D, P, Q);
    heads<T>(a, P, Q, LDW, row_base, rows_total, sig, rgb);
    // the next tile's encode writes only E and D; the barrier after it
    // orders these reads of P and Q before the next tile's first layer
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < a.rays_per_cta; r += THREADS / 32) {
    const int ray = ray0 + r;
    if (ray < a.n) composite_ray(a, ray, sig + r * a.s, rgb + r * a.s * 3);
  }
}

template <class T>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.n + a.rays_per_cta - 1) / a.rays_per_cta;
  fused_fwd_kernel<T><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or a
// negative code for arguments the kernel does not take (-1 sizes, -2 S above
// the per-CTA sample buffer, -3 encoding wider than its padded slot).
extern "C" int fused_raymarch_fwd(const void* o, const void* d, const void* ts, int n, int s,
                                  int position_dim, int direction_dim, int is_bf16,
                                  const void* ws, const void* bs, void* color, void* weights,
                                  void* stream) {
  if (n < 1 || s < 1) return -1;
  if (s > MAX_RAY_ROWS) return -2;
  if (6 * position_dim > KE || 6 * direction_dim > KD || position_dim < 1 || direction_dim < 1)
    return -3;
  FwdArgs a;
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
  for (int i = 0; i < 12; ++i) a.w[i] = wp[i];
  for (int i = 0; i < 10; ++i) a.b[i] = bp[i];
  a.color = static_cast<float*>(color);
  a.weights = static_cast<float*>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
