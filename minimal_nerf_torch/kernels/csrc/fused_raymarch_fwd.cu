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
//   * One CTA owns a group of whole rays and walks their samples in row
//     tiles (128 rows in bf16, 64 in fp32); nothing of the MLP touches
//     device memory.
//   * bf16: the Hopper MLP of mlp_fwd_sm90.cuh (wgmma with each layer's
//     output kept in registers as the next one's A operand, weights staged
//     by TMA through a ring in shared memory, two consumer warpgroups of 64
//     rows, the heads in the epilogues), on a persistent grid of one CTA
//     per SM that walks ray groups. Three encoder warps form each tile's
//     positions x = (o + t*d) / pi once per row and its encodings (one
//     sincosf per cos/sin pair) into the other E/D buffer while the
//     consumers multiply; the direction encoding is formed once per ray,
//     not per sample.
//   * fp32 (the comparison path): 8 warps on the FMA units over 64-row
//     tiles in shared-memory ping-pong buffers, [K, N] weights
//     (fused_raymarch_common.cuh).
//   * Compositing is one warp per ray: each lane owns a run of consecutive
//     samples and the exclusive prefix of -sigma*delta is a warp-shuffle
//     scan, so no triangular matmul and no padding to multiples of 8.
//   * Ragged edges (rays past N, rows past the last sample) are masked.
// Tried before on an H100 (PERF.md): mma.sync with each weight fragment
// streamed from L2, and a cp.async weight ring with a CTA barrier per k-step.

#include "mlp_fwd_sm90.cuh"

namespace {

struct FwdArgs : RayArgs {
  float* color;
  float* weights;
};

// fp32: activations P, Q [M, 256+pad], encodings E, D [M, ...], per-sample
// sigma and rgb, the per-ray direction encodings [MAX_RAYS, KD+pad], then
// each tile row's position [M, 3] and ray [M]
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

// the fp32 forward (the bf16 one is fused_fwd_sm90)
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

// ------------------------------------------------------------ bf16, sm_90a

struct alignas(64) FwdSm90Params {
  WeightMaps maps;
  FwdArgs a;
};

constexpr int LDD_SM90 = KD + 8;  // the per-ray direction encodings' row (80 bytes)
// beside the MLP's: per-sample sigma and rgb, the per-ray direction
// encodings [MAX_RAYS, LDD_SM90], each tile row's position and ray
constexpr size_t FWD_SM90_EXTRA = sizeof(float) * 4 * MAX_RAY_ROWS +
                                  sizeof(__nv_bfloat16) * MAX_RAYS * LDD_SM90 +
                                  (sizeof(float) * 3 + sizeof(int)) * TILE_ROWS;

// the encoders' share of a group at ray0: each ray's direction encoding
// once (encode_dirs on ENC_THREADS threads)
__device__ __forceinline__ void encode_dirs_sw(const FwdArgs& a, int ray0, __nv_bfloat16* dray,
                                               int tid) {
  for (int idx = tid; idx < a.rays_per_cta * (KD / 2); idx += ENC_THREADS) {
    const int rl = idx / (KD / 2), p = idx % (KD / 2);
    const float* dv = a.d + min(ray0 + rl, a.n - 1) * 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
                               __fmul_rn(dv[2], dv[2]));
    encode_pair<__nv_bfloat16>(dray + rl * LDD_SM90, p, a.dir_ch / 2, a.dir_ch,
                               __fmul_rn(dv[p % 3], rsqrtf(ss)));
  }
}

// the encoders' share of a tile: its 128 rows from row_base of the group at
// ray0 into buffer buf, E (positions) and D (the rows' rays' direction
// encodings, zero past KD), sw128, the rows of consumer warpgroup r / 64
// in its own pair
__device__ __forceinline__ void encode_tile_sw(const FwdArgs& a, int ray0, int row_base,
                                               const Sm90Smem& sm, int buf,
                                               const __nv_bfloat16* dray, float* xs, int* rayl,
                                               int tid) {
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
    encode_pair_sw(sm.enc(buf, r / WG_ROWS), r % WG_ROWS, p, a.pos_ch / 2, a.pos_ch,
                   xs[r * 3 + p % 3]);
  }
  for (int idx = tid; idx < TILE_ROWS * (KC / 8); idx += ENC_THREADS) {
    const int r = idx / (KC / 8), c = idx % (KC / 8), rr = r % WG_ROWS;  // 16-byte piece c
    const uint4 v = c < KD / 8
                        ? *reinterpret_cast<const uint4*>(dray + rayl[r] * LDD_SM90 + c * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sm.dir(buf, r / WG_ROWS) + rr * 128 + ((c ^ (rr & 7)) << 4)) = v;
  }
}

// the heads of a warpgroup's rows into the CTA's sample buffers
struct RayOut {
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

__global__ void __launch_bounds__(SM90_THREADS, 1)
    fused_fwd_sm90(const __grid_constant__ FwdSm90Params prm) {
  extern __shared__ unsigned char smem_raw[];
  const Sm90Smem sm = sm90_setup(smem_raw);
  const FwdArgs& a = prm.a;
  const int groups = (a.n + a.rays_per_cta - 1) / a.rays_per_cta;
  const int rows_total = a.rays_per_cta * a.s;
  const int tiles = (rows_total + TILE_ROWS - 1) / TILE_ROWS;
  const int iters = persistent_iters(groups);
  float* sig = reinterpret_cast<float*>(sm.extra());
  float* rgb = sig + MAX_RAY_ROWS;
  __nv_bfloat16* dray = reinterpret_cast<__nv_bfloat16*>(rgb + 3 * MAX_RAY_ROWS);
  float* xs = reinterpret_cast<float*>(dray + MAX_RAYS * LDD_SM90);
  int* rayl = reinterpret_cast<int*>(xs + TILE_ROWS * 3);
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMER_WGS) {
    producer_setup();
    const int tid = threadIdx.x % WG_THREADS;
    if (tid == 0) {
      produce(prm.maps, sm, iters * tiles);
    } else if (tid >= 32) {  // the encoders, a group (past n: all masked) at a time
      EncBufs eb{sm.enc_bars(), 0, 0};
      for (int it = 0; it < iters; ++it) {
        const int ray0 = (blockIdx.x + it * gridDim.x) * a.rays_per_cta;
        named_sync(BAR_ENCODERS, ENC_THREADS);  // the last group's D copies read dray
        encode_dirs_sw(a, ray0, dray, tid - 32);
        for (int row_base = 0; row_base < rows_total; row_base += TILE_ROWS) {
          eb.acquire();
          named_sync(BAR_ENCODERS, ENC_THREADS);  // dray written; the last tile read xs, rayl
          encode_tile_sw(a, ray0, row_base, sm, eb.buf, dray, xs, rayl, tid - 32);
          eb.publish();
        }
      }
    }
  } else {
    consumer_setup();
    Ring ring{saddr(sm.base), sm.bars(), 0, 0};
    EncBufs eb{sm.enc_bars(), 0, 0};
    for (int it = 0; it < iters; ++it) {
      const int ray0 = (blockIdx.x + it * gridDim.x) * a.rays_per_cta;
      named_sync(BAR_CONSUMERS, CONSUMER_WGS * WG_THREADS);  // the last compositing read sig, rgb
      for (int row_base = 0; row_base < rows_total; row_base += TILE_ROWS) {
        const int row0 = row_base + wg * WG_ROWS;
        eb.wait();
        mlp_rows(a, ring, sm.enc(eb.buf, wg), sm.dir(eb.buf, wg),
                 RayOut{sig, rgb, row0, rows_total});
        eb.release();
      }
      named_sync(BAR_CONSUMERS, CONSUMER_WGS * WG_THREADS);  // every row's heads are in
      const int warp = threadIdx.x >> 5;
      for (int r = warp; r < a.rays_per_cta; r += CONSUMER_WGS * WG_THREADS / 32) {
        const int ray = ray0 + r;
        if (ray < a.n) composite_ray(a, ray, sig + r * a.s, rgb + r * a.s * 3);
      }
    }
  }
}

static_assert(sm90_smem_bytes(FWD_SM90_EXTRA) <= 232448, "above the shared memory of one block");

int launch_sm90(const FwdArgs& a, const void* maps, cudaStream_t stream) {
  FwdSm90Params prm;
  memcpy(&prm.maps, maps, sizeof(WeightMaps));
  prm.a = a;
  return launch_persistent(fused_fwd_sm90, prm, (a.n + a.rays_per_cta - 1) / a.rays_per_cta,
                           sm90_smem_bytes(FWD_SM90_EXTRA), stream);
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or a
// negative code for arguments the kernel does not take (-1 sizes, -2 S above
// the per-CTA sample buffer, -3 encoding wider than its padded slot, -4 bf16
// without tensor maps). bf16 reads the weights through maps
// (mlp_fwd_sm90_maps) and of ws only the heads' (DW, R1); fp32 reads ws.
extern "C" int fused_raymarch_fwd(const void* o, const void* d, const void* ts, int n, int s,
                                  int position_dim, int direction_dim, int is_bf16,
                                  const void* ws, const void* bs, const void* maps, void* color,
                                  void* weights, void* stream) {
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
  if (!is_bf16) return launch<float>(a, st);
  if (maps == nullptr) return -4;
  return launch_sm90(a, maps, st);
}
