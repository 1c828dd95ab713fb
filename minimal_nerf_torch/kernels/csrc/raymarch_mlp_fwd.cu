// Point-level NeRF MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nerf_mlp_kernel` of
// minimal_nerf_tpu/kernels/raymarch.py (launched by `_pallas_points_forward`,
// public as `nerf_mlp_pallas_apply`): the `--kernel pallas` path, where the
// render around the MLP (sampling, compositing) stays in PyTorch. For every
// point it computes, without writing any intermediate to device memory:
//   the frequency-major cos-before-sin positional encodings of its position
//   x / pi and its unit direction (60 + 24 channels, each point its own),
//   the 8-layer skip MLP, and its density and rgb heads.
// Inputs x, d [P, 3] fp32; outputs sigma [P, 1] and rgb [P, 3], fp32.
//
// Numerics follow `_nerf_mlp_kernel`: under bf16, x and d are rounded to
// bf16 before the encoding angles are formed, and every matmul operand (the
// encodings, the activations, h) is rounded to bf16; matmuls accumulate in
// fp32, biases are added in fp32, sigma and rgb are fp32. The skip and rgb
// concatenations are split matmuls.
//
// What bounds it: tensor-core operations, 460,416 multiply-adds per point
// against 40 bytes of point traffic (x and d in, sigma and rgb out) and
// ~1 MB of bf16 weights read from L2: a 4096-ray chunk at 64 + 192 samples
// is ~0.97 TFLOP against ~42 MB.
//
// Design: the fused forward's MLP without its rays (fused_raymarch_common.cuh).
// One CTA (8 warps) owns one tile of points (128 rows in bf16, 64 in fp32);
// the tile's activations stay in shared-memory ping-pong buffers, bf16
// layers run on mma.sync with weights pre-packed in fragment order and
// streamed from L2, the fp32 path on the FMA units; the heads are warp dot
// products that write straight to sigma and rgb. The ragged last tile
// encodes zeros past P and stores nothing there. The TPU kernel's padding
// of P to whole tiles is not needed.

#include "fused_raymarch_common.cuh"

namespace {

struct PointFwdArgs : PointArgs {
  float* sigma;
  float* rgb;
};

// activations P, Q [M, 256+pad], encodings E, D [M, 64+pad], [M, 32+pad]
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD));
}

template <class T>
__global__ void __launch_bounds__(THREADS) points_fwd_kernel(PointFwdArgs a) {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  T* Q = P + M * LDW;
  T* E = Q + M * LDW;
  T* D = E + M * LDE;

  const long long p0 = (long long)blockIdx.x * M;
  encode_points<T>(a, p0, E, LDE, D, LDD);
  __syncthreads();
  mlp_forward<T>(a, E, D, P, Q);
  heads<T>(a, P, Q, LDW, 0, (int)min((long long)M, a.p - p0), a.sigma + p0, a.rgb + p0 * 3);
}

template <class T>
int launch(const PointFwdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      points_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (a.p + Tile<T>::M - 1) / Tile<T>::M;
  points_fwd_kernel<T><<<(unsigned)grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or a
// negative code for arguments the kernel does not take (-1 sizes, -3
// encoding wider than its padded slot).
extern "C" int raymarch_mlp_fwd(const void* x, const void* d, int p, int position_dim,
                                int direction_dim, int is_bf16, const void* ws, const void* bs,
                                void* sigma, void* rgb, void* stream) {
  if (p < 1) return -1;
  if (6 * position_dim > KE || 6 * direction_dim > KD || position_dim < 1 || direction_dim < 1)
    return -3;
  PointFwdArgs a;
  a.x = static_cast<const float*>(x);
  a.dir = static_cast<const float*>(d);
  a.p = p;
  a.pos_ch = 6 * position_dim;
  a.dir_ch = 6 * direction_dim;
  const void* const* wp = static_cast<const void* const*>(ws);
  const float* const* bp = static_cast<const float* const*>(bs);
  for (int i = 0; i < 12; ++i) a.w[i] = wp[i];
  for (int i = 0; i < 10; ++i) a.b[i] = bp[i];
  a.sigma = static_cast<float*>(sigma);
  a.rgb = static_cast<float*>(rgb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
