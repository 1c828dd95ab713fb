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
// Design: the fused forward's MLP without its rays. bf16 runs the Hopper
// MLP of mlp_fwd_sm90.cuh (wgmma with each layer's output kept in
// registers, weights staged by TMA, two consumer warpgroups of 64 rows, the
// heads in the epilogues writing straight to sigma and rgb) on a persistent
// grid of one CTA per SM that walks 128-point tiles. The producer
// warpgroup's three encoder warps write each tile's position encodings
// into the other E buffer while the consumers multiply; each consumer
// warpgroup encodes its rows' directions (12 of the 42 sincosf of a point)
// itself, which keeps the encoders ahead. fp32 (the comparison path) is one
// CTA of 8 warps per 64-point tile on the FMA units
// (fused_raymarch_common.cuh). The ragged last tile encodes zeros past P
// and stores nothing there. The TPU kernel's padding of P to whole tiles is
// not needed.

#include "mlp_fwd_sm90.cuh"

namespace {

struct PointFwdArgs : PointArgs {
  float* sigma;
  float* rgb;
};

// fp32: activations P, Q [M, 256+pad], encodings E, D [M, 64+pad], [M, 32+pad]
template <class T>
constexpr size_t smem_bytes() {
  constexpr int M = Tile<T>::M, PAD = Tile<T>::PAD;
  return sizeof(T) * (size_t)M * (2 * (WIDTH + PAD) + (KE + PAD) + (KD + PAD));
}

// the fp32 forward (the bf16 one is points_fwd_sm90)
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

// ------------------------------------------------------------ bf16, sm_90a

struct alignas(64) PointSm90Params {
  WeightMaps maps;
  PointFwdArgs a;
};

// beside the MLP's: each tile row's x
constexpr size_t POINT_SM90_EXTRA = sizeof(float) * 3 * TILE_ROWS;

// the encoders' share of the tile from p0 into buffer buf: each row's x
// into xs once (zeros past p), then the position encodings into E, sw128,
// the rows of consumer warpgroup r / 64 in its own E
__device__ __forceinline__ void encode_positions_sw(const PointArgs& a, long long p0,
                                                    const Sm90Smem& sm, int buf, float* xs,
                                                    int tid) {
  for (int idx = tid; idx < TILE_ROWS * 3; idx += ENC_THREADS)
    xs[idx] = p0 + idx / 3 < a.p ? a.x[p0 * 3 + idx] : 0.f;
  named_sync(BAR_ENCODERS, ENC_THREADS);
  for (int idx = tid; idx < TILE_ROWS * (KC / 2); idx += ENC_THREADS) {
    const int r = idx / (KC / 2), q = idx % (KC / 2);
    encode_pair_sw(sm.enc(buf, r / WG_ROWS), r % WG_ROWS, q, a.pos_ch / 2, a.pos_ch,
                   xs[r * 3 + q % 3]);
  }
}

// a consumer warpgroup's share: the direction encodings of its 64 rows
// from p0 into D (zero from dir_ch to 64, and past p), sw128, made visible
// to its products; the encoders' share per row would hold the products up
__device__ __forceinline__ void encode_directions_sw(const PointArgs& a, long long p0,
                                                     unsigned char* D, int wg) {
  for (int idx = threadIdx.x % WG_THREADS; idx < WG_ROWS * (KC / 2); idx += WG_THREADS) {
    const int r = idx / (KC / 2), q = idx % (KC / 2);
    const long long row = p0 + r;
    encode_pair_sw(D, r, q, a.dir_ch / 2, a.dir_ch,
                   row < a.p && q < a.dir_ch / 2 ? a.dir[row * 3 + q % 3] : 0.f);
  }
  fence_async_shared();
  named_sync(BAR_WG0 + wg, WG_THREADS);
}

// the heads of a warpgroup's rows from p0 into sigma and rgb, rows < p
struct PointOut {
  float* sig;
  float* col;
  long long p0, p;
  __device__ __forceinline__ void sigma(int r, float v) const {
    if (p0 + r < p) sig[p0 + r] = v;
  }
  __device__ __forceinline__ void rgb(int r, float c0, float c1, float c2) const {
    if (p0 + r < p) {
      float* o = col + (p0 + r) * 3;
      o[0] = c0;
      o[1] = c1;
      o[2] = c2;
    }
  }
};

__global__ void __launch_bounds__(SM90_THREADS, 1)
    points_fwd_sm90(const __grid_constant__ PointSm90Params prm) {
  extern __shared__ unsigned char smem_raw[];
  const Sm90Smem sm = sm90_setup(smem_raw);
  const PointFwdArgs& a = prm.a;
  const long long tiles = (a.p + TILE_ROWS - 1) / TILE_ROWS;
  const int iters = persistent_iters(tiles);
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMER_WGS) {
    producer_setup();
    const int tid = threadIdx.x % WG_THREADS;
    if (tid == 0) {
      produce(prm.maps, sm, iters);
    } else if (tid >= 32) {  // the encoders
      float* xs = reinterpret_cast<float*>(sm.extra());
      EncBufs eb{sm.enc_bars(), 0, 0};
      for (int it = 0; it < iters; ++it) {  // tiles past the last: all rows masked
        eb.acquire();
        named_sync(BAR_ENCODERS, ENC_THREADS);  // the last tile read xs
        encode_positions_sw(a, (blockIdx.x + (long long)it * gridDim.x) * TILE_ROWS, sm, eb.buf,
                            xs, tid - 32);
        eb.publish();
      }
    }
  } else {
    consumer_setup();
    Ring ring{saddr(sm.base), sm.bars(), 0, 0};
    EncBufs eb{sm.enc_bars(), 0, 0};
    for (int it = 0; it < iters; ++it) {
      const long long p0 = (blockIdx.x + (long long)it * gridDim.x) * TILE_ROWS + wg * WG_ROWS;
      eb.wait();
      encode_directions_sw(a, p0, sm.dir(eb.buf, wg), wg);
      mlp_rows(a, ring, sm.enc(eb.buf, wg), sm.dir(eb.buf, wg), PointOut{a.sigma, a.rgb, p0, a.p});
      eb.release();
    }
  }
}

static_assert(sm90_smem_bytes(POINT_SM90_EXTRA) <= 232448, "above the shared memory of one block");

int launch_sm90(const PointFwdArgs& a, const void* maps, cudaStream_t stream) {
  PointSm90Params prm;
  memcpy(&prm.maps, maps, sizeof(WeightMaps));
  prm.a = a;
  return launch_persistent(points_fwd_sm90, prm, (a.p + TILE_ROWS - 1) / TILE_ROWS,
                           sm90_smem_bytes(POINT_SM90_EXTRA), stream);
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or a
// negative code for arguments the kernel does not take (-1 sizes, -3
// encoding wider than its padded slot, -4 bf16 without tensor maps). bf16
// reads the weights through maps (mlp_fwd_sm90_maps) and of ws only the
// heads' (DW, R1); fp32 reads ws.
extern "C" int raymarch_mlp_fwd(const void* x, const void* d, int p, int position_dim,
                                int direction_dim, int is_bf16, const void* ws, const void* bs,
                                const void* maps, void* sigma, void* rgb, void* stream) {
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
  if (!is_bf16) return launch<float>(a, st);
  if (maps == nullptr) return -4;
  return launch_sm90(a, maps, st);
}
