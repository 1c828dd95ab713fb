// Device code shared by the fused ray-march kernels (fused_raymarch_fwd.cu,
// fused_raymarch_bwd.cu) and the point-level MLP kernels (raymarch_mlp_fwd.cu,
// raymarch_mlp_bwd.cu): the layer widths, the kernels' arguments, the tile
// shapes, the bf16 mma.sync and fp32 FMA dense layers with a caller-given
// epilogue, the in-kernel positional encodings, the forward layer chain, the
// density / rgb heads, and the backward's scratch layout and reverse sweep.
// See fused_raymarch_fwd.cu and fused_raymarch_bwd.cu for the numerics.

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
// the transposed weights of the reverse sweep
enum { T1T, T2T, T3T, F0HT, F1T, F2T, R0HT };

// the MLP every kernel reads
struct MlpArgs {
  int pos_ch, dir_ch;
  const void* w[12];
  const float* b[10];
};

// what both fused kernels read of one pass: rays, sample times, the MLP
struct RayArgs : MlpArgs {
  const float* o;
  const float* d;
  const float* ts;
  int n, s, rays_per_cta;
};

// what both point kernels read: positions / pi and unit directions [p, 3]
struct PointArgs : MlpArgs {
  const float* x;
  const float* dir;
  long long p;
};

// M rows per tile; SUM_ROWS partial column sums per tile in dense(SUM)
template <class T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int M = 128, PAD = 8, SUM_ROWS = 2; };
template <> struct Tile<float> { static constexpr int M = 64, PAD = 4, SUM_ROWS = 8; };

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
// rows x NOUT/4 columns. epi(row, col, sum) gives the stored value. With
// SUM, also the fp32 sums of each column's stored values before they are
// rounded to bf16: warp row wm (64 rows) writes colsum[wm * ld + col].
template <int NOUT, bool SUM, class Epi>
__device__ void dense_mma(const __nv_bfloat16* a1, int lda1, int k1, const void* w1,
                          const __nv_bfloat16* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, __nv_bfloat16* out, int ldo, float* colsum, int ld) {
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
  float cs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = wm * 64 + mt * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (wn * NT + j) * 8 + t * 2;
      const float v0 = epi(row, col, acc[mt][j][0]), v1 = epi(row, col + 1, acc[mt][j][1]);
      const float v2 = epi(row + 8, col, acc[mt][j][2]);
      const float v3 = epi(row + 8, col + 1, acc[mt][j][3]);
      *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(v2, v3);
      if constexpr (SUM) {
        cs[j][0] += v0 + v2;
        cs[j][1] += v1 + v3;
      }
    }
  }
  if constexpr (SUM) {
    // the 8 lanes of one t hold the same columns of the warp's 64 rows
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[j][e];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        if (g == 0) colsum[wm * ld + (wn * NT + j) * 8 + t * 2 + e] = v;
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
// 4 rows x NOUT/16 interleaved columns. With SUM, also each column's sums:
// warp w (8 rows) writes colsum[w * ld + col].
template <int NOUT, bool SUM, class Epi>
__device__ void dense_fma(const float* a1, int lda1, int k1, const void* w1,
                          const float* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, float* out, int ldo, float* colsum, int ld) {
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
  float cs[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) cs[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      const float v = epi(ty * 4 + i, col, acc[i][j]);
      out[(ty * 4 + i) * ldo + col] = v;
      if constexpr (SUM) cs[j] += v;
    }
  if constexpr (SUM) {
    // lanes tx and tx + 16 of a warp hold the same column
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float v = cs[j] + __shfl_xor_sync(FULL, cs[j], 16);
      if ((threadIdx.x & 16) == 0) colsum[(threadIdx.x >> 5) * ld + tx + 16 * j] = v;
    }
  }
}

// the dense layer of the compute dtype; SUM adds the column sums (colsum:
// SUM_ROWS partial rows of stride ld)
template <int NOUT, class T, bool SUM = false, class Epi>
__device__ __forceinline__ void dense(const T* a1, int lda1, int k1, const void* w1,
                                      const T* a2, int lda2, int k2, const void* w2,
                                      const Epi& epi, T* out, int ldo, float* colsum = nullptr,
                                      int ld = 0) {
  if constexpr (std::is_same<T, float>::value)
    dense_fma<NOUT, SUM>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo, colsum, ld);
  else
    dense_mma<NOUT, SUM>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo, colsum, ld);
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

// a point tile's position and direction encodings, each point's own (the
// TPU point kernel encodes d per point); rows past p encode zeros
template <class T>
__device__ void encode_points(const PointArgs& a, long long p0, T* E, int lde, T* D, int ldd) {
  constexpr int M = Tile<T>::M;
  for (int idx = threadIdx.x; idx < M * (KE / 2); idx += THREADS) {
    const int r = idx / (KE / 2), q = idx % (KE / 2);
    const long long row = p0 + r;
    encode_pair<T>(E + r * lde, q, a.pos_ch / 2, a.pos_ch, row < a.p ? a.x[row * 3 + q % 3] : 0.f);
  }
  for (int idx = threadIdx.x; idx < M * (KD / 2); idx += THREADS) {
    const int r = idx / (KD / 2), q = idx % (KD / 2);
    const long long row = p0 + r;
    encode_pair<T>(D + r * ldd, q, a.dir_ch / 2, a.dir_ch,
                   row < a.p ? a.dir[row * 3 + q % 3] : 0.f);
  }
}

// sigma = relu(h . dw + db), rgb = sigmoid(r0 @ r1w + r1b) of rows
// [row_base, rows_total) of the tile: one warp per row
template <class T>
__device__ void heads(const MlpArgs& a, const T* h, const T* r0, int ld, int row_base,
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

// -------------------------------------------------- the backward's scratch

// scratch channel blocks ([channel][point]): layer inputs, then layer
// output gradients (the order of SCRATCH_CHANNELS in fused_raymarch.py)
enum : int {
  C_E = 0,
  C_ED = C_E + KE,
  C_A0 = C_ED + KD,
  C_A1 = C_A0 + WIDTH,
  C_A2 = C_A1 + WIDTH,
  C_A3 = C_A2 + WIDTH,
  C_A4 = C_A3 + WIDTH,
  C_A5 = C_A4 + WIDTH,
  C_H = C_A5 + WIDTH,
  C_R0 = C_H + WIDTH,
  C_GA0 = C_R0 + RGB_WIDTH,
  C_GA1 = C_GA0 + WIDTH,
  C_GA2 = C_GA1 + WIDTH,
  C_GA3 = C_GA2 + WIDTH,
  C_GA4 = C_GA3 + WIDTH,
  C_GA5 = C_GA4 + WIDTH,
  C_GH = C_GA5 + WIDTH,
  C_GR0 = C_GH + WIDTH,
  C_HEAD = C_GR0 + RGB_WIDTH,  // g_sigpre, g_rgbpre[3], 4 zeros
  CHANNELS = C_HEAD + 8,
  BIAS_CH = CHANNELS - C_GA0,  // one bias sum per gradient channel
};

// rows [0, rows) of a tile [M, ld] -> scratch channels [ch][p0 + row]
template <class T>
__device__ void store_cols(const T* src, int ld, int ch, T* dst, long long pal, long long p0,
                           int rows) {
  constexpr int M = Tile<T>::M;
  for (int idx = threadIdx.x; idx < M * ch; idx += THREADS) {
    const int c = idx / M, r = idx % M;
    if (r < rows) dst[c * pal + p0 + r] = src[r * ld + c];
  }
}

// The MLP over one tile: the encodings E, D -> h in P, r0 in Q (ping-pong
// through P and Q, a barrier after each layer). With KEEP, also every
// layer's input (e, ed, a0..a5, h, r0), rows [0, rows), to the scratch at
// points p0.. (each store reads a buffer that the next layer only reads).
template <class T, bool KEEP = false>
__device__ __forceinline__ void mlp_forward(const MlpArgs& a, const T* E, const T* D, T* P,
                                            T* Q, T* sc = nullptr, long long pal = 0,
                                            long long p0 = 0, int rows = 0) {
  constexpr int PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  auto keep = [&](const T* src, int ld, int ch, int channel) {
    if constexpr (KEEP) store_cols<T>(src, ld, ch, sc + (long long)channel * pal, pal, p0, rows);
  };
  keep(E, LDE, KE, C_E);
  keep(D, LDD, KD, C_ED);
  dense<WIDTH, T>(E, LDE, KE, a.w[T0], nullptr, 0, 0, nullptr,
                  BiasAct<true>{a.b[T0B]}, P, LDW);
  __syncthreads();
  keep(P, LDW, WIDTH, C_A0);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[T1], nullptr, 0, 0, nullptr,
                  BiasAct<true>{a.b[T1B]}, Q, LDW);
  __syncthreads();
  keep(Q, LDW, WIDTH, C_A1);
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[T2], nullptr, 0, 0, nullptr,
                  BiasAct<true>{a.b[T2B]}, P, LDW);
  __syncthreads();
  keep(P, LDW, WIDTH, C_A2);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[T3], nullptr, 0, 0, nullptr,
                  BiasAct<true>{a.b[T3B]}, Q, LDW);
  __syncthreads();
  keep(Q, LDW, WIDTH, C_A3);
  // skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F0H], E, LDE, KE, a.w[F0E],
                  BiasAct<true>{a.b[F0B]}, P, LDW);
  __syncthreads();
  keep(P, LDW, WIDTH, C_A4);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[F1], nullptr, 0, 0, nullptr,
                  BiasAct<true>{a.b[F1B]}, Q, LDW);
  __syncthreads();
  keep(Q, LDW, WIDTH, C_A5);
  // h: no activation
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F2], nullptr, 0, 0, nullptr,
                  BiasAct<false>{a.b[F2B]}, P, LDW);
  __syncthreads();
  keep(P, LDW, WIDTH, C_H);
  // rgb hidden: concat(h, ed) @ W == h @ W_h + ed @ W_d
  dense<RGB_WIDTH, T>(P, LDW, WIDTH, a.w[R0H], D, LDD, KD, a.w[R0D],
                      BiasAct<true>{a.b[R0B]}, Q, LDW);
  __syncthreads();
  keep(Q, LDW, RGB_WIDTH, C_R0);
}

// a ReLU layer's input gradient: the product where the layer's stored
// activation is > 0, else 0
template <class T>
struct MaskAct {
  const T* act;
  long long pal, p0;
  int rows;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    return row < rows && tof(act[col * pal + p0 + row]) > 0.f ? v : 0.f;
  }
};

// g_h = g_r0 @ R0H^T + g_sigpre * dw (no activation)
template <class T>
struct HeadGrad {
  const float* gsig;
  const T* dw;
  int rows;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    return row < rows ? __fadd_rn(v, __fmul_rn(gsig[row], tof(dw[col]))) : 0.f;
  }
};

// The reverse sweep of one tile whose layer inputs are in the scratch at
// points p0.. (rows [0, rows)), from the heads' gradients gsig [M] (g_sigpre)
// and grgb [M, 3] (g_rgbpre), both already rounded to T: keeps every
// layer's output gradient (g_r0, g_h, g_a5..g_a0, and the heads' block) in
// the scratch, rounded to T, through products with the transposed weights
// wt. With SUM, also the fp32 column sums of each gradient before its
// rounding: row k of bsum [SUM_ROWS][BIAS_CH] (channel c at c - C_GA0)
// receives the partial sums of the k-th group of rows (see dense).
template <class T, bool SUM = false>
__device__ __forceinline__ void reverse_sweep(const MlpArgs& a, const void* const* wt, T* P, T* Q,
                                              T* sc, long long pal, long long p0, int rows,
                                              const float* gsig, const float* grgb,
                                              float* bsum = nullptr) {
  constexpr int M = Tile<T>::M, LDW = WIDTH + Tile<T>::PAD;
  auto chan = [&](int c) { return sc + (long long)c * pal; };
  auto sums = [&](int c) { return SUM ? bsum + (c - C_GA0) : nullptr; };
  const T* r1w = static_cast<const T*>(a.w[R1]);  // [3, RGB_WIDTH]
  for (int idx = threadIdx.x; idx < M * 8; idx += THREADS) {
    const int c = idx / M, r = idx % M;
    if (r < rows)
      chan(C_HEAD + c)[p0 + r] = fromf<T>(c == 0 ? gsig[r] : (c < 4 ? grgb[r * 3 + c - 1] : 0.f));
  }
  // g_r0 = (g_rgbpre @ r1w^T) masked by r0 > 0; thread i owns column
  // i % RGB_WIDTH of the rows of parity i / RGB_WIDTH
  float s = 0.f;
  for (int idx = threadIdx.x; idx < M * RGB_WIDTH; idx += THREADS) {
    const int r = idx / RGB_WIDTH, j = idx % RGB_WIDTH;
    float v = 0.f;
    if (r < rows && tof(chan(C_R0 + j)[p0 + r]) > 0.f) {
      const float* g = grgb + r * 3;
      v = __fadd_rn(__fadd_rn(__fmul_rn(g[0], tof(r1w[j])),
                              __fmul_rn(g[1], tof(r1w[RGB_WIDTH + j]))),
                    __fmul_rn(g[2], tof(r1w[2 * RGB_WIDTH + j])));
    }
    P[r * LDW + j] = fromf<T>(v);
    if constexpr (SUM) s += v;
  }
  if constexpr (SUM)
    bsum[(threadIdx.x / RGB_WIDTH) * BIAS_CH + C_GR0 - C_GA0 + threadIdx.x % RGB_WIDTH] = s;
  __syncthreads();
  store_cols<T>(P, LDW, RGB_WIDTH, chan(C_GR0), pal, p0, rows);
  dense<WIDTH, T, SUM>(P, LDW, RGB_WIDTH, wt[R0HT], nullptr, 0, 0, nullptr,
                       HeadGrad<T>{gsig, static_cast<const T*>(a.w[DW]), rows}, Q, LDW,
                       sums(C_GH), BIAS_CH);
  __syncthreads();
  store_cols<T>(Q, LDW, WIDTH, chan(C_GH), pal, p0, rows);
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[F2T], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A5), pal, p0, rows}, P, LDW, sums(C_GA5), BIAS_CH);
  __syncthreads();
  store_cols<T>(P, LDW, WIDTH, chan(C_GA5), pal, p0, rows);
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[F1T], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A4), pal, p0, rows}, Q, LDW, sums(C_GA4), BIAS_CH);
  __syncthreads();
  store_cols<T>(Q, LDW, WIDTH, chan(C_GA4), pal, p0, rows);
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[F0HT], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A3), pal, p0, rows}, P, LDW, sums(C_GA3), BIAS_CH);
  __syncthreads();
  store_cols<T>(P, LDW, WIDTH, chan(C_GA3), pal, p0, rows);
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[T3T], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A2), pal, p0, rows}, Q, LDW, sums(C_GA2), BIAS_CH);
  __syncthreads();
  store_cols<T>(Q, LDW, WIDTH, chan(C_GA2), pal, p0, rows);
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[T2T], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A1), pal, p0, rows}, P, LDW, sums(C_GA1), BIAS_CH);
  __syncthreads();
  store_cols<T>(P, LDW, WIDTH, chan(C_GA1), pal, p0, rows);
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[T1T], nullptr, 0, 0, nullptr,
                       MaskAct<T>{chan(C_A0), pal, p0, rows}, Q, LDW, sums(C_GA0), BIAS_CH);
  __syncthreads();
  store_cols<T>(Q, LDW, WIDTH, chan(C_GA0), pal, p0, rows);
}

}  // namespace
