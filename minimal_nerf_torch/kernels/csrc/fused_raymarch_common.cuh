// Device code shared by the fused ray-march forward and backward kernels
// (fused_raymarch_fwd.cu, fused_raymarch_bwd.cu): the layer widths, the
// per-ray arguments, the tile shapes, the bf16 mma.sync and fp32 FMA dense
// layers with a caller-given epilogue, the in-kernel positional encoding and
// the density / rgb heads. See fused_raymarch_fwd.cu for the numerics.

#pragma once

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

// what both kernels read of one pass: rays, sample times, the MLP
struct RayArgs {
  const float* o;
  const float* d;
  const float* ts;
  int n, s, rays_per_cta, pos_ch, dir_ch;
  const void* w[12];
  const float* b[10];
};

template <class T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int M = 128, PAD = 8; };
template <> struct Tile<float> { static constexpr int M = 64, PAD = 4; };

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

// whole rays per CTA, chosen so their rows fill the 128-row tiles where the
// sample buffer allows
inline int rays_per_cta(int s) {
  int x = s, y = 128;
  while (y) {
    const int r = x % y;
    x = y;
    y = r;
  }
  int rays = 128 / x;
  while (rays > 1 && rays * s > MAX_RAY_ROWS) rays /= 2;  // rays <= MAX_RAYS
  return rays;
}

// the forward layers' epilogue: bias, then ReLU or nothing
template <bool RELU>
struct BiasAct {
  const float* bias;
  __device__ __forceinline__ float operator()(int, int col, float v) const {
    v += __ldg(bias + col);
    return RELU ? fmaxf(v, 0.f) : v;
  }
};

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

// out = epi(a1 @ w1 [+ a2 @ w2]) for a 128-row tile; 2 x 4 warps, each 64
// rows x NOUT/4 columns. epi(row, col, sum) gives the stored value.
template <int NOUT, class Epi>
__device__ void dense_mma(const __nv_bfloat16* a1, int lda1, int k1, const void* w1,
                          const __nv_bfloat16* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, __nv_bfloat16* out, int ldo) {
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
      *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(
          epi(row, col, acc[mt][j][0]), epi(row, col + 1, acc[mt][j][1]));
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) = __floats2bfloat162_rn(
          epi(row + 8, col, acc[mt][j][2]), epi(row + 8, col + 1, acc[mt][j][3]));
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

// out = epi(a1 @ w1 [+ a2 @ w2]) for a 64-row tile; 16 x 16 threads, each
// 4 rows x NOUT/16 interleaved columns.
template <int NOUT, class Epi>
__device__ void dense_fma(const float* a1, int lda1, int k1, const void* w1,
                          const float* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, float* out, int ldo) {
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
      out[(ty * 4 + i) * ldo + col] = epi(ty * 4 + i, col, acc[i][j]);
    }
}

template <int NOUT, class T, class Epi>
__device__ __forceinline__ void dense(const T* a1, int lda1, int k1, const void* w1,
                                      const T* a2, int lda2, int k2, const void* w2,
                                      const Epi& epi, T* out, int ldo) {
  if constexpr (std::is_same<T, float>::value)
    dense_fma<NOUT>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo);
  else
    dense_mma<NOUT>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo);
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
__device__ void encode_dirs(const RayArgs& a, int ray0, T* dray, int ldd) {
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
__device__ void encode_tile(const RayArgs& a, int ray0, int row_base, T* E, int lde, T* D,
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
__device__ void heads(const RayArgs& a, const T* h, const T* r0, int ld, int row_base,
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

// the forward's sample -> delta of one ray: t[i+1] - t[i], 1e10 for the last
__device__ __forceinline__ float sample_delta(const float* t, int i, int s) {
  return i + 1 < s ? __fsub_rn(t[i + 1], t[i]) : 1e10f;
}

}  // namespace
