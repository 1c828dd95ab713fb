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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;           // 8 warps
constexpr int WIDTH = 256;             // trunk width
constexpr int RGB_WIDTH = 128;         // rgb hidden width
constexpr int KE = 64;                 // position encoding, padded (6 * position_dim <= 64)
constexpr int KD = 32;                 // direction encoding, padded (6 * direction_dim <= 32)
constexpr int MAX_RAY_ROWS = 1024;     // samples of one CTA's rays held for compositing
constexpr int MAX_RAYS = 128;          // rays of one CTA (S = 1 gives the most)
constexpr float INV_PI = 0.318309886183790671538f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr unsigned FULL = 0xffffffffu;

// weight / bias slots, in the order of flatten_mlp_params
enum { T0, T1, T2, T3, F0H, F0E, F1, F2, DW, R0H, R0D, R1 };
enum { T0B, T1B, T2B, T3B, F0B, F1B, F2B, DB, R0B, R1B };

struct FwdArgs {
  const float* o;
  const float* d;
  const float* ts;
  int n, s, rays_per_cta, pos_ch, dir_ch;
  const void* w[12];
  const float* b[10];
  float* color;
  float* weights;
};

template <class T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int M = 128, PAD = 8; };
template <> struct Tile<float> { static constexpr int M = 64, PAD = 4; };

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

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ---------------------------------------------------------------- bf16 MLP

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[64 rows of this warp][NT n-tiles of 8] += A[rows, k] @ W[k, cols].
// W is packed as uint2[NOUT/8][k/16][32 lanes]: lane (g, t) of n-tile j and
// k-step kk holds W^T[j*8+g][kk*16 + t*2 + {0,1}] and [... + 8 + {0,1}].
template <int NT>
__device__ __forceinline__ void mma_accumulate(float (&acc)[4][NT][4],
                                               const __nv_bfloat16* a, int lda, int k,
                                               const uint2* w, int wm, int wn, int lane) {
  const int ksteps = k / 16;
  const int g = lane >> 2, t = lane & 3;
  const uint2* wp = w + (size_t)(wn * NT) * ksteps * 32 + lane;
  uint2 bcur[NT], bnext[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bcur[j] = __ldg(wp + (size_t)j * ksteps * 32);
  for (int kk = 0; kk < ksteps; ++kk) {
    const bool more = kk + 1 < ksteps;
    if (more) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bnext[j] = __ldg(wp + ((size_t)j * ksteps + kk + 1) * 32);
    }
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* base = a + (wm * 64 + mt * 16 + g) * lda + kk * 16 + t * 2;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * lda);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * lda + 8);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], af[mt], bcur[j]);
    if (more) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bcur[j] = bnext[j];
    }
  }
}

// out = act(a1 @ w1 [+ a2 @ w2] + bias) for a 128-row tile; 2 x 4 warps,
// each 64 rows x NOUT/4 columns.
template <int NOUT, bool RELU>
__device__ void dense_mma(const __nv_bfloat16* a1, int lda1, int k1, const void* w1,
                          const __nv_bfloat16* a2, int lda2, int k2, const void* w2,
                          const float* bias, __nv_bfloat16* out, int ldo) {
  constexpr int NT = NOUT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  mma_accumulate<NT>(acc, a1, lda1, k1, static_cast<const uint2*>(w1), wm, wn, lane);
  if (a2 != nullptr)
    mma_accumulate<NT>(acc, a2, lda2, k2, static_cast<const uint2*>(w2), wm, wn, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = wm * 64 + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (wn * NT + j) * 8 + t * 2;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
      float v0 = acc[mt][j][0] + b0, v1 = acc[mt][j][1] + b1;
      float v2 = acc[mt][j][2] + b0, v3 = acc[mt][j][3] + b1;
      if (RELU) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
}

// ---------------------------------------------------------------- fp32 MLP

// acc[4 rows][NC cols] += A[rows, k] @ W[k, cols]; W is [k, NOUT] row-major.
template <int NC, int NOUT>
__device__ __forceinline__ void fma_accumulate(float (&acc)[4][NC], const float* a, int lda,
                                               int k, const float* w, int tx, int ty) {
  for (int kk = 0; kk < k; ++kk) {
    float av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * lda + kk];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float wv = __ldg(w + (size_t)kk * NOUT + tx + 16 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], wv, acc[i][j]);
    }
  }
}

// out = act(a1 @ w1 [+ a2 @ w2] + bias) for a 64-row tile; 16 x 16 threads,
// each 4 rows x NOUT/16 interleaved columns.
template <int NOUT, bool RELU>
__device__ void dense_fma(const float* a1, int lda1, int k1, const void* w1,
                          const float* a2, int lda2, int k2, const void* w2,
                          const float* bias, float* out, int ldo) {
  constexpr int NC = NOUT / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  fma_accumulate<NC, NOUT>(acc, a1, lda1, k1, static_cast<const float*>(w1), tx, ty);
  if (a2 != nullptr)
    fma_accumulate<NC, NOUT>(acc, a2, lda2, k2, static_cast<const float*>(w2), tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      float v = acc[i][j] + __ldg(bias + col);
      if (RELU) v = fmaxf(v, 0.f);
      out[(ty * 4 + i) * ldo + col] = v;
    }
}

template <int NOUT, bool RELU, class T>
__device__ __forceinline__ void dense(const T* a1, int lda1, int k1, const void* w1,
                                      const T* a2, int lda2, int k2, const void* w2,
                                      const float* bias, T* out, int ldo) {
  if constexpr (std::is_same<T, float>::value)
    dense_fma<NOUT, RELU>(a1, lda1, k1, w1, a2, lda2, k2, w2, bias, out, ldo);
  else
    dense_mma<NOUT, RELU>(a1, lda1, k1, w1, a2, lda2, k2, w2, bias, out, ldo);
}

// ------------------------------------------------------- encoding and heads

// Channel c encodes coordinate c % 3 at frequency 2^(c/6) * pi, sin iff
// (c / 3) is odd, so channels 6f+k (cos) and 6f+k+3 (sin) share one angle:
// pair p = 3f+k is one sincosf. The coordinate is rounded to T first (as the
// TPU kernel's `x.astype(dtype) @ selector` does). Pairs past `pairs` zero
// the padding channels.
template <class T>
__device__ __forceinline__ void encode_pair(T* row, int p, int pairs, int channels,
                                            float coord) {
  if (p < pairs) {
    const int f = p / 3, c = 6 * f + p % 3;
    const float ang = __fmul_rn(tof(fromf<T>(coord)), ldexpf(PI_F, f));
    float sn, cs;
    sincosf(ang, &sn, &cs);
    row[c] = fromf<T>(cs);
    row[c + 3] = fromf<T>(sn);
  } else {
    const int c = channels + 2 * (p - pairs);
    row[c] = fromf<T>(0.f);
    row[c + 1] = fromf<T>(0.f);
  }
}

// the direction encoding of each of the CTA's rays, once (not per sample)
template <class T>
__device__ void encode_dirs(const FwdArgs& a, int ray0, T* dray, int ldd) {
  for (int idx = threadIdx.x; idx < a.rays_per_cta * (KD / 2); idx += THREADS) {
    const int rl = idx / (KD / 2), p = idx % (KD / 2);
    const float* dv = a.d + min(ray0 + rl, a.n - 1) * 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
                               __fmul_rn(dv[2], dv[2]));
    encode_pair<T>(dray + rl * ldd, p, a.dir_ch / 2, a.dir_ch, __fmul_rn(dv[p % 3], rsqrtf(ss)));
  }
}

// a tile's position encodings E, and its rows' copies D of the ray
// encodings. First each row's position x = (o + t*d) / pi and ray, so the
// channel loops divide by S nowhere.
template <class T>
__device__ void encode_tile(const FwdArgs& a, int ray0, int row_base, T* E, int lde, T* D,
                            const T* dray, int ldd, float* xs, int* rayl) {
  constexpr int M = Tile<T>::M;
  for (int r = threadIdx.x; r < M; r += THREADS) {
    const int row = row_base + r, rl = row / a.s;
    const int ray = min(ray0 + rl, a.n - 1);  // rows past the end: any valid ray
    const float t = a.ts[(size_t)ray * a.s + (row - rl * a.s)];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      xs[r * 3 + k] = __fmul_rn(__fadd_rn(a.o[ray * 3 + k], __fmul_rn(t, a.d[ray * 3 + k])),
                                INV_PI);
    rayl[r] = min(rl, a.rays_per_cta - 1);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * (KE / 2); idx += THREADS) {
    const int r = idx / (KE / 2), p = idx % (KE / 2);
    encode_pair<T>(E + r * lde, p, a.pos_ch / 2, a.pos_ch, xs[r * 3 + p % 3]);
  }
  for (int idx = threadIdx.x; idx < M * KD; idx += THREADS) {
    const int r = idx / KD, c = idx % KD;
    D[r * ldd + c] = dray[rayl[r] * ldd + c];
  }
}

// sigma = relu(h . dw + db), rgb = sigmoid(r0 @ r1w + r1b): one warp per row
template <class T>
__device__ void heads(const FwdArgs& a, const T* h, const T* r0, int ld, int row_base,
                      int rows_total, float* sig, float* rgb) {
  constexpr int M = Tile<T>::M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* dw = static_cast<const T*>(a.w[DW]);
  const T* r1w = static_cast<const T*>(a.w[R1]);  // [3, RGB_WIDTH]
  for (int r = warp; r < M; r += THREADS / 32) {
    const int row = row_base + r;
    if (row >= rows_total) break;
    float s = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int k = lane; k < WIDTH; k += 32) s = fmaf(tof(h[r * ld + k]), tof(dw[k]), s);
    for (int k = lane; k < RGB_WIDTH; k += 32) {
      const float v = tof(r0[r * ld + k]);
      c0 = fmaf(v, tof(r1w[k]), c0);
      c1 = fmaf(v, tof(r1w[RGB_WIDTH + k]), c1);
      c2 = fmaf(v, tof(r1w[2 * RGB_WIDTH + k]), c2);
    }
    s = warp_sum(s); c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
    if (lane == 0) {
      const float* rb = a.b[R1B];
      sig[row] = fmaxf(s + a.b[DB][0], 0.f);
      rgb[row * 3 + 0] = 1.f / (1.f + expf(-(c0 + rb[0])));
      rgb[row * 3 + 1] = 1.f / (1.f + expf(-(c1 + rb[1])));
      rgb[row * 3 + 2] = 1.f / (1.f + expf(-(c2 + rb[2])));
    }
  }
}

// deltas, exclusive-prefix transmittance, weights and color of one ray (one warp)
__device__ void composite_ray(const FwdArgs& a, int ray, const float* sig, const float* rgb) {
  const int lane = threadIdx.x & 31, s = a.s;
  const float* t = a.ts + (size_t)ray * s;
  const int per = (s + 31) / 32, lo = min(lane * per, s), hi = min(lo + per, s);
  auto ndd = [&](int i) {
    const float delta = i + 1 < s ? __fsub_rn(t[i + 1], t[i]) : 1e10f;
    return __fmul_rn(-sig[i], delta);
  };
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
    dense<WIDTH, true, T>(E, LDE, KE, a.w[T0], nullptr, 0, 0, nullptr, a.b[T0B], P, LDW);
    __syncthreads();
    dense<WIDTH, true, T>(P, LDW, WIDTH, a.w[T1], nullptr, 0, 0, nullptr, a.b[T1B], Q, LDW);
    __syncthreads();
    dense<WIDTH, true, T>(Q, LDW, WIDTH, a.w[T2], nullptr, 0, 0, nullptr, a.b[T2B], P, LDW);
    __syncthreads();
    dense<WIDTH, true, T>(P, LDW, WIDTH, a.w[T3], nullptr, 0, 0, nullptr, a.b[T3B], Q, LDW);
    __syncthreads();
    // skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
    dense<WIDTH, true, T>(Q, LDW, WIDTH, a.w[F0H], E, LDE, KE, a.w[F0E], a.b[F0B], P, LDW);
    __syncthreads();
    dense<WIDTH, true, T>(P, LDW, WIDTH, a.w[F1], nullptr, 0, 0, nullptr, a.b[F1B], Q, LDW);
    __syncthreads();
    // h: no activation
    dense<WIDTH, false, T>(Q, LDW, WIDTH, a.w[F2], nullptr, 0, 0, nullptr, a.b[F2B], P, LDW);
    __syncthreads();
    // rgb hidden: concat(h, ed) @ W == h @ W_h + ed @ W_d
    dense<RGB_WIDTH, true, T>(P, LDW, WIDTH, a.w[R0H], D, LDD, KD, a.w[R0D], a.b[R0B], Q, LDW);
    __syncthreads();
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

int gcd(int x, int y) {
  while (y) {
    const int r = x % y;
    x = y;
    y = r;
  }
  return x;
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
  // whole rays per CTA, chosen so their rows fill the 128-row tiles where
  // the sample buffer allows
  int rays = 128 / gcd(s, 128);
  while (rays > 1 && rays * s > MAX_RAY_ROWS) rays /= 2;  // rays <= MAX_RAYS

  FwdArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.ts = static_cast<const float*>(ts);
  a.n = n;
  a.s = s;
  a.rays_per_cta = rays;
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
