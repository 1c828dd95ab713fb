// Device code shared by the fused ray-march kernels (fused_raymarch_fwd.cu,
// fused_raymarch_bwd.cu) and the point-level MLP kernels (raymarch_mlp_fwd.cu,
// raymarch_mlp_bwd.cu): the layer widths, the kernels' arguments, the tile
// shapes, the bf16 mma.sync and fp32 FMA dense layers with a caller-given
// epilogue, the in-kernel positional encodings, the forward layer chain, the
// density / rgb heads, and the backward's scratch layout, ReLU mask bits and
// reverse sweep. See fused_raymarch_fwd.cu and fused_raymarch_bwd.cu for the
// numerics.

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

// M rows per tile; SUM_ROWS rows of WIDTH partial column sums that a tile's
// sums pass through (red): one per warp of dense_fma; dense_mma needs none,
// the reverse sweep's g_r0 block one (THREADS floats)
template <class T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int M = 128, PAD = 8, SUM_ROWS = 1; };
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

// A dense layer's epilogue gives each output element its stored value:
// epi.window(row, lo) once per row and range of at most 32 columns from lo
// that lies in one 32-column word (dense_mma), or 64 columns from a multiple
// of 64 (dense_fma), then epi(window, col, sum) per element of it.

// the forward layers' epilogue: bias, then ReLU or nothing
template <bool RELU>
struct BiasAct {
  const float* bias;
  __device__ __forceinline__ int window(int, int) const { return 0; }
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

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes). TRANS: each matrix transposed.
template <bool TRANS = false>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Work a dense layer carries beside its products: side(kk, ksteps) once per
// k-step (the backward's scratch stores, KeepRows); NoKeep does nothing.
struct NoKeep {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// acc[MT m-tiles of 16 rows][NT n-tiles of 8 from n-tile nt0] +=
// A[rows, k] @ W[k, cols], and side(kk, ksteps) at each k-step (k >= 32).
// Each weight fragment is loaded from L2 two k-steps ahead of its products
// (one step ahead left the warps waiting on L2). W is packed
// as uint2[NOUT/8][k/16][32 lanes]: lane (g, t) of n-tile j and k-step kk
// holds W^T[j*8+g][kk*16 + t*2 + {0,1}] and [... + 8 + {0,1}]. A's fragments
// come from shared memory by ldmatrix: matrices 0-3 are rows 0-7 / 8-15 at
// k 0-7, then at k 8-15, the order of the mma's A registers (a row stride
// of 16 bytes times an odd number keeps the 8 rows of a matrix on distinct
// banks).
template <int MT, int NT, class Side>
__device__ __forceinline__ void mma_accumulate(float (&acc)[MT][NT][4],
                                               const __nv_bfloat16* a, int lda, int k,
                                               const uint2* w, int nt0, int lane,
                                               const Side& side) {
  const int ksteps = k / 16;
  const uint2* wp = w + (size_t)nt0 * ksteps * 32 + lane;
  const __nv_bfloat16* arow =
      a + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 8;
  uint2 bcur[NT], bnext[NT], bfar[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bcur[j] = __ldg(wp + (size_t)j * ksteps * 32);
#pragma unroll
  for (int j = 0; j < NT; ++j) bnext[j] = __ldg(wp + ((size_t)j * ksteps + 1) * 32);
  for (int kk = 0; kk < ksteps; ++kk) {
    const bool more = kk + 1 < ksteps;
    if (kk + 2 < ksteps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) bfar[j] = __ldg(wp + ((size_t)j * ksteps + kk + 2) * 32);
    }
    side(kk, ksteps);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      ldmatrix_x4(af, arow + mt * 16 * lda + kk * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], af, bcur[j]);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bcur[j] = bnext[j];
        bnext[j] = bfar[j];
      }
    }
  }
}

// colsum[col] += the partial column sums red[k][col] of the SUM_ROWS groups
// of rows, in k order; the caller's barrier orders it before the next use
// of red or colsum
template <int NOUT, int ROWS>
__device__ __forceinline__ void add_colsums(const float* red, float* colsum) {
  __syncthreads();
  for (int c = threadIdx.x; c < NOUT; c += THREADS) {
    float s = red[c];
#pragma unroll
    for (int k = 1; k < ROWS; ++k) s += red[k * NOUT + c];
    colsum[c] += s;
  }
}

// out = epi(a1 @ w1 [+ a2 @ w2]) for a 128-row tile, with side() spread over
// the k-steps of a1. Warp w owns every row of the NOUT / 8 columns from
// w * NOUT / 8, so each weight fragment crosses from L2 once per tile, not
// once per warp row, and a column's sum stays in one warp. With SUM, also
// colsum[col] += the fp32 sum of each column's stored values before their
// rounding to bf16, from one lane per
// column.
template <int NOUT, bool SUM, class Epi, class Side>
__device__ void dense_mma(const __nv_bfloat16* a1, int lda1, int k1, const void* w1,
                          const __nv_bfloat16* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, __nv_bfloat16* out, int ldo, float* colsum,
                          const Side& side) {
  constexpr int MT = Tile<__nv_bfloat16>::M / 16, NT = NOUT / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  mma_accumulate<MT, NT>(acc, a1, lda1, k1, static_cast<const uint2*>(w1), warp * NT, lane,
                         side);
  if (a2 != nullptr)
    mma_accumulate<MT, NT>(acc, a2, lda2, k2, static_cast<const uint2*>(w2), warp * NT, lane,
                           NoKeep{});
  const int g = lane >> 2, t = lane & 3;
  float cs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = mt * 16 + g;
    const auto w0 = epi.window(row, warp * NT * 8), w8 = epi.window(row + 8, warp * NT * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (warp * NT + j) * 8 + t * 2;
      const float v0 = epi(w0, col, acc[mt][j][0]), v1 = epi(w0, col + 1, acc[mt][j][1]);
      const float v2 = epi(w8, col, acc[mt][j][2]), v3 = epi(w8, col + 1, acc[mt][j][3]);
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
    // the 8 lanes of one t hold the same columns of all the tile's rows
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[j][e];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        if (g == 0) colsum[(warp * NT + j) * 8 + t * 2 + e] += v;
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

// out = epi(a1 @ w1 [+ a2 @ w2]) for a 64-row tile, after side() (all of it
// at once); 16 x 16 threads, each 4 rows x NOUT/16 interleaved columns.
// With SUM, also colsum[col] += each column's sum (fp32: nothing is
// rounded), through the partial sums red[SUM_ROWS][NOUT] of the 8 warps (8
// rows each).
template <int NOUT, bool SUM, class Epi, class Side>
__device__ void dense_fma(const float* a1, int lda1, int k1, const void* w1,
                          const float* a2, int lda2, int k2, const void* w2,
                          const Epi& epi, float* out, int ldo, float* colsum, float* red,
                          const Side& side) {
  constexpr int NC = NOUT / 16;
  side(0, 1);
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
    for (int q = 0; q < NC / 4; ++q) {
      // columns tx + 16 j of j in [4q, 4q + 4) lie in [64q, 64q + 64)
      const auto win = epi.window(ty * 4 + i, 64 * q);
#pragma unroll
      for (int j = 4 * q; j < 4 * q + 4; ++j) {
        const int col = tx + 16 * j;
        const float v = epi(win, col, acc[i][j]);
        out[(ty * 4 + i) * ldo + col] = v;
        if constexpr (SUM) cs[j] += v;
      }
    }
  if constexpr (SUM) {
    // lanes tx and tx + 16 of a warp hold the same column
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float v = cs[j] + __shfl_xor_sync(FULL, cs[j], 16);
      if ((threadIdx.x & 16) == 0) red[(threadIdx.x >> 5) * NOUT + tx + 16 * j] = v;
    }
    add_colsums<NOUT, Tile<float>::SUM_ROWS>(red, colsum);
  }
}

// the dense layer of the compute dtype; with SUM, colsum[col] += the column
// sums (red: SUM_ROWS * NOUT floats of scratch); side: work carried beside
// the products
template <int NOUT, class T, bool SUM = false, class Epi, class Side = NoKeep>
__device__ __forceinline__ void dense(const T* a1, int lda1, int k1, const void* w1,
                                      const T* a2, int lda2, int k2, const void* w2,
                                      const Epi& epi, T* out, int ldo, float* colsum = nullptr,
                                      float* red = nullptr, const Side& side = Side()) {
  if constexpr (std::is_same<T, float>::value)
    dense_fma<NOUT, SUM>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo, colsum, red, side);
  else
    dense_mma<NOUT, SUM>(a1, lda1, k1, w1, a2, lda2, k2, w2, epi, out, ldo, colsum, side);
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

// scratch channel blocks: layer inputs, then layer output gradients (the
// order of SCRATCH_CHANNELS in fused_raymarch.py). Each block is its own
// row-major matrix [points][block width] (Scratch), so a tile's rows of one
// layer are one contiguous run of device memory, and kernel B's operand
// tiles are rows of one matrix.
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

// The scratch of `points` points: the block of channels [c0, c0 + w) is a
// matrix [points][w] at base + points * c0, so point p's channel c0 + j
// lies at base + points * c0 + p * w + j (block widths and starts are
// multiples of 8: rows are whole 16-byte pieces).
template <class T>
struct Scratch {
  T* base;
  long long points;
  __device__ __forceinline__ T* row(int c0, int w, long long p) const {
    return base + points * c0 + p * w;
  }
};

// The ReLU masks of one point as bits (bit c % 32 of word c / 32 of a
// layer: its stored activation c is > 0): a0..a5 in words 8 l .. 8 l + 7,
// r0 in words MW_R0 .. MW_R0 + 3. 208 bytes per point where the activations
// themselves take 3,328 in bf16.
enum : int { MW_R0 = 6 * (WIDTH / 32), MASK_WORDS = MW_R0 + RGB_WIDTH / 32 };

// bit k: element k of a 16-byte piece of T values is > 0
template <class T>
__device__ __forceinline__ uint32_t positive_bits(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<T, float>::value) {
      bits |= (__uint_as_float(w[k]) > 0.f ? 1u : 0u) << k;
    } else {  // two bf16, the first in the low half
      bits |= (__uint_as_float(w[k] << 16) > 0.f ? 1u : 0u) << (2 * k);
      bits |= (__uint_as_float(w[k] & 0xffff0000u) > 0.f ? 1u : 0u) << (2 * k + 1);
    }
  }
  return bits;
}

// Rows [0, rows) of a tile [M, ld] of CH channels -> the scratch block rows
// from dst (a block of width CH), as 16-byte streaming stores (marked for
// eviction first: only kernel B reads them, long after), the pieces of a
// row on consecutive lanes. Called as a dense layer's side work,
// keep(kk, ksteps) stores this thread's share of k-step kk, so the 64 KB of
// a 256-channel bf16 tile drain while the tensor cores work instead of in
// one burst from every SM at once; keep(0, 1) stores it all.
template <class T, int CH>
struct KeepRows {
  static constexpr int VEC = 16 / sizeof(T), PER_ROW = CH / VEC;
  static constexpr int PER_THREAD = Tile<T>::M * PER_ROW / THREADS;  // exact for every CH
  const T* src;
  int ld;
  T* dst;
  int rows;
  __device__ __forceinline__ void operator()(int kk, int ksteps) const {
    const int i0 = kk * PER_THREAD / ksteps, i1 = (kk + 1) * PER_THREAD / ksteps;
    for (int i = i0; i < i1; ++i) {
      const int idx = threadIdx.x + i * THREADS, r = idx / PER_ROW, c = idx % PER_ROW;
      if (r < rows)
        __stcs(reinterpret_cast<uint4*>(dst + r * CH + c * VEC),
               *reinterpret_cast<const uint4*>(src + r * ld + c * VEC));
    }
  }
};

// two layers' stores carried by one dense layer
template <class A, class B>
struct KeepBoth {
  A a;
  B b;
  __device__ __forceinline__ void operator()(int kk, int ksteps) const {
    a(kk, ksteps);
    b(kk, ksteps);
  }
};

// the stores of a tile's rows [0, rows) at channel ch0 when KEEP, else none
template <class T, int CH, bool KEEP>
__device__ __forceinline__ auto keep_rows(const T* src, int ld, const Scratch<T>& sc,
                                          long long p0, int ch0, int rows) {
  if constexpr (KEEP)
    return KeepRows<T, CH>{src, ld, sc.row(ch0, CH, p0), rows};
  else
    return NoKeep{};
}

// The ReLU mask words (stored value > 0) of rows [0, rows) of a tile [M, ld]
// (ch channels): mbits[row * MASK_WORDS + w0 + c / 32] (shared or device
// memory), each thread testing one 16-byte piece of a row, the pieces of a
// row on consecutive lanes.
template <class T>
__device__ void mask_bits(const T* src, int ld, int ch, int rows, uint32_t* mbits, int w0) {
  constexpr int M = Tile<T>::M, VEC = 16 / sizeof(T), LANES = 32 / VEC;  // pieces per word
  const int per_row = ch / VEC;
  // M * per_row is a multiple of THREADS for every masked layer, so all
  // lanes of a warp take part in the shuffles
  for (int idx = threadIdx.x; idx < M * per_row; idx += THREADS) {
    const int r = idx / per_row, c = idx - r * per_row;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * ld + c * VEC);
    uint32_t bits = positive_bits<T>(v) << ((c % LANES) * VEC);
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) bits |= __shfl_xor_sync(FULL, bits, off);
    if (c % LANES == 0 && r < rows) mbits[r * MASK_WORDS + w0 + c / LANES] = bits;
  }
}

// The MLP over one tile: the encodings E, D -> h in P, r0 in Q (ping-pong
// through P and Q, a barrier after each layer). With KEEP, also every
// layer's input (e, ed, a0..a5, h, r0), rows [0, rows), to the scratch rows
// p0.., each stored while the layer that reads it runs (r0 after the last),
// and the ReLU layers' mask bits to mbits.
template <class T, bool KEEP = false>
__device__ __forceinline__ void mlp_forward(const MlpArgs& a, const T* E, const T* D, T* P,
                                            T* Q, Scratch<T> sc = {}, long long p0 = 0,
                                            int rows = 0, uint32_t* mbits = nullptr) {
  constexpr int PAD = Tile<T>::PAD;
  constexpr int LDW = WIDTH + PAD, LDE = KE + PAD, LDD = KD + PAD;
  auto keep = [&](const T* src, int ch0) {
    return keep_rows<T, WIDTH, KEEP>(src, LDW, sc, p0, ch0, rows);
  };
  auto masks = [&](const T* src, int ch, int w0) {
    if constexpr (KEEP) mask_bits<T>(src, LDW, ch, rows, mbits, w0);
  };
  dense<WIDTH, T>(E, LDE, KE, a.w[T0], nullptr, 0, 0, nullptr, BiasAct<true>{a.b[T0B]}, P, LDW,
                  nullptr, nullptr,
                  KeepBoth<decltype(keep_rows<T, KE, KEEP>(E, LDE, sc, p0, C_E, rows)),
                           decltype(keep_rows<T, KD, KEEP>(D, LDD, sc, p0, C_ED, rows))>{
                      keep_rows<T, KE, KEEP>(E, LDE, sc, p0, C_E, rows),
                      keep_rows<T, KD, KEEP>(D, LDD, sc, p0, C_ED, rows)});
  __syncthreads();
  masks(P, WIDTH, 0);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[T1], nullptr, 0, 0, nullptr, BiasAct<true>{a.b[T1B]}, Q,
                  LDW, nullptr, nullptr, keep(P, C_A0));
  __syncthreads();
  masks(Q, WIDTH, 8);
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[T2], nullptr, 0, 0, nullptr, BiasAct<true>{a.b[T2B]}, P,
                  LDW, nullptr, nullptr, keep(Q, C_A1));
  __syncthreads();
  masks(P, WIDTH, 16);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[T3], nullptr, 0, 0, nullptr, BiasAct<true>{a.b[T3B]}, Q,
                  LDW, nullptr, nullptr, keep(P, C_A2));
  __syncthreads();
  masks(Q, WIDTH, 24);
  // skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F0H], E, LDE, KE, a.w[F0E], BiasAct<true>{a.b[F0B]}, P,
                  LDW, nullptr, nullptr, keep(Q, C_A3));
  __syncthreads();
  masks(P, WIDTH, 32);
  dense<WIDTH, T>(P, LDW, WIDTH, a.w[F1], nullptr, 0, 0, nullptr, BiasAct<true>{a.b[F1B]}, Q,
                  LDW, nullptr, nullptr, keep(P, C_A4));
  __syncthreads();
  masks(Q, WIDTH, 40);
  // h: no activation
  dense<WIDTH, T>(Q, LDW, WIDTH, a.w[F2], nullptr, 0, 0, nullptr, BiasAct<false>{a.b[F2B]}, P,
                  LDW, nullptr, nullptr, keep(Q, C_A5));
  __syncthreads();
  // rgb hidden: concat(h, ed) @ W == h @ W_h + ed @ W_d
  dense<RGB_WIDTH, T>(P, LDW, WIDTH, a.w[R0H], D, LDD, KD, a.w[R0D], BiasAct<true>{a.b[R0B]}, Q,
                      LDW, nullptr, nullptr, keep(P, C_H));
  __syncthreads();
  keep_rows<T, RGB_WIDTH, KEEP>(Q, LDW, sc, p0, C_R0, rows)(0, 1);
  masks(Q, RGB_WIDTH, MW_R0);
}

// a ReLU layer's input gradient: the product where the layer's stored
// activation is > 0 (its bit in the tile's mask words mk [M][MASK_WORDS],
// layer words from w0), else 0; rows past `rows` give 0
struct MaskAct {
  const uint32_t* mk;
  int w0, rows;
  struct Window {
    unsigned long long bits;  // the 64 columns from lo
    int lo;                   // a multiple of 32
  };
  __device__ __forceinline__ Window window(int row, int lo) const {
    if (row >= rows) return {0ull, lo};
    const uint32_t* w = mk + row * MASK_WORDS + w0 + (lo >> 5);
    return {(unsigned long long)w[0] | ((unsigned long long)w[1] << 32), lo};
  }
  __device__ __forceinline__ float operator()(const Window& win, int col, float v) const {
    return (win.bits >> (col - win.lo)) & 1ull ? v : 0.f;
  }
};

// g_h = g_r0 @ R0H^T + g_sigpre * dw (no activation)
template <class T>
struct HeadGrad {
  const float* gsig;
  const T* dw;
  int rows;
  struct Window {
    float g;  // the row's g_sigpre
    bool in;  // row < rows
  };
  __device__ __forceinline__ Window window(int row, int) const {
    return row < rows ? Window{gsig[row], true} : Window{0.f, false};
  }
  __device__ __forceinline__ float operator()(const Window& w, int col, float v) const {
    return w.in ? __fadd_rn(v, __fmul_rn(w.g, tof(dw[col]))) : 0.f;
  }
};

// The reverse sweep of one tile whose layer inputs are in the scratch at
// rows p0.. (rows [0, rows)) and whose ReLU masks are in mk [M][MASK_WORDS]
// (shared memory), from the heads' gradients gsig [M] (g_sigpre) and
// grgb [M, 3] (g_rgbpre), both already rounded to T: keeps every layer's
// output gradient (g_r0, g_h, g_a5..g_a0, and the heads' block) in the
// scratch, rounded to T, through products with the transposed weights wt.
// With SUM, also bsum[c - C_GA0] += the column sums of each gradient
// channel c of g_r0 .. g_a0, of the fp32 values before their rounding,
// through red [SUM_ROWS * WIDTH] floats. Each
// gradient is stored while the layer that reads it runs (g_a0 after the
// last), as in mlp_forward<KEEP>.
template <class T, bool SUM = false>
__device__ __forceinline__ void reverse_sweep(const MlpArgs& a, const void* const* wt, T* P, T* Q,
                                              const Scratch<T>& sc, long long p0, int rows,
                                              const float* gsig,
                                              const float* grgb, const uint32_t* mk,
                                              float* bsum = nullptr, float* red = nullptr) {
  constexpr int M = Tile<T>::M, LDW = WIDTH + Tile<T>::PAD;
  auto sums = [&](int c) { return SUM ? bsum + (c - C_GA0) : nullptr; };
  const T* r1w = static_cast<const T*>(a.w[R1]);  // [3, RGB_WIDTH]
  // the heads' block: one 16-byte piece per row (two in fp32)
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    __align__(16) T head[8];
    head[0] = fromf<T>(gsig[r]);
#pragma unroll
    for (int k = 0; k < 3; ++k) head[k + 1] = fromf<T>(grgb[r * 3 + k]);
#pragma unroll
    for (int k = 4; k < 8; ++k) head[k] = fromf<T>(0.f);
    uint4* dst = reinterpret_cast<uint4*>(sc.row(C_HEAD, 8, p0 + r));
#pragma unroll
    for (int q = 0; q < (int)sizeof(head) / 16; ++q)
      __stcs(dst + q, reinterpret_cast<const uint4*>(head)[q]);
  }
  // g_r0 = (g_rgbpre @ r1w^T) masked by r0 > 0; thread i owns column
  // i % RGB_WIDTH of the rows of parity i / RGB_WIDTH
  float s = 0.f;
  for (int idx = threadIdx.x; idx < M * RGB_WIDTH; idx += THREADS) {
    const int r = idx / RGB_WIDTH, j = idx % RGB_WIDTH;
    float v = 0.f;
    if (r < rows && ((mk[r * MASK_WORDS + MW_R0 + (j >> 5)] >> (j & 31)) & 1u)) {
      const float* g = grgb + r * 3;
      v = __fadd_rn(__fadd_rn(__fmul_rn(g[0], tof(r1w[j])),
                              __fmul_rn(g[1], tof(r1w[RGB_WIDTH + j]))),
                    __fmul_rn(g[2], tof(r1w[2 * RGB_WIDTH + j])));
    }
    P[r * LDW + j] = fromf<T>(v);
    if constexpr (SUM) s += v;
  }
  if constexpr (SUM) {
    red[threadIdx.x] = s;
    add_colsums<RGB_WIDTH, THREADS / RGB_WIDTH>(red, bsum + (C_GR0 - C_GA0));
  }
  __syncthreads();
  auto keep = [&](const T* src, int ch0) {
    return KeepRows<T, WIDTH>{src, LDW, sc.row(ch0, WIDTH, p0), rows};
  };
  dense<WIDTH, T, SUM>(P, LDW, RGB_WIDTH, wt[R0HT], nullptr, 0, 0, nullptr,
                       HeadGrad<T>{gsig, static_cast<const T*>(a.w[DW]), rows}, Q, LDW,
                       sums(C_GH), red,
                       KeepRows<T, RGB_WIDTH>{P, LDW, sc.row(C_GR0, RGB_WIDTH, p0), rows});
  __syncthreads();
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[F2T], nullptr, 0, 0, nullptr, MaskAct{mk, 40, rows}, P,
                       LDW, sums(C_GA5), red, keep(Q, C_GH));
  __syncthreads();
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[F1T], nullptr, 0, 0, nullptr, MaskAct{mk, 32, rows}, Q,
                       LDW, sums(C_GA4), red, keep(P, C_GA5));
  __syncthreads();
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[F0HT], nullptr, 0, 0, nullptr, MaskAct{mk, 24, rows}, P,
                       LDW, sums(C_GA3), red, keep(Q, C_GA4));
  __syncthreads();
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[T3T], nullptr, 0, 0, nullptr, MaskAct{mk, 16, rows}, Q,
                       LDW, sums(C_GA2), red, keep(P, C_GA3));
  __syncthreads();
  dense<WIDTH, T, SUM>(Q, LDW, WIDTH, wt[T2T], nullptr, 0, 0, nullptr, MaskAct{mk, 8, rows}, P,
                       LDW, sums(C_GA1), red, keep(Q, C_GA2));
  __syncthreads();
  dense<WIDTH, T, SUM>(P, LDW, WIDTH, wt[T1T], nullptr, 0, 0, nullptr, MaskAct{mk, 0, rows}, Q,
                       LDW, sums(C_GA0), red, keep(P, C_GA1));
  __syncthreads();
  keep(Q, C_GA0)(0, 1);
}

}  // namespace
