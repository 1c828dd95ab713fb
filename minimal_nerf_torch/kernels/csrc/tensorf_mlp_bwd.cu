// TensoRF's shading chain, backward, on Hopper (sm_90a): from the forward's
// inputs, its packed weights (tensorf_mlp_fwd.cu) and the color's gradient
// drgb [P, 3] -> the products' gradient dprods [P, 144] and the basis's and
// the three layers' gradients, fp32. Replaces no TPU kernel (the JAX package
// has no TensoRF); the plain version is autograd of
// kernels/tensorf_mlp.py::mlp_plain. Three kernels, one call:
//
//   tensorf_mlp_bwd_kernel     per point: the forward recomputed (the
//       features, the encodings, both hidden layers and their ReLU masks),
//       then the reverse sweep dz3 = drgb s (1 - s); dz2 = (dz3 W3^T) masked;
//       dz1 = (dz2 W2^T) masked; dh0 = dz1 W1^T over the slots of a; da = the
//       direct slots plus 2^f (cos dsin - sin dcos) of the encodings;
//       dprods = da basis^T, written fp32. Each product's inputs rounded to
//       bf16, sums fp32, as the forward. It also writes each weight
//       gradient's operands, bf16, as the scratch [P, width] matrices of
//       tensorf_mlp_common.cuh (X0, XP, X1, X2: the layers' inputs; G1, G2,
//       G3, GA: the gradients of their outputs), 1,712 bytes a point.
//   tensorf_mlp_wgrad_kernel   out[k, n] = sum_p X[p, k] G[p, n] of the four
//       products (dW1, dW2, dW3, dbasis) and the column sums of G1, G2, G3
//       (the biases' gradients), fp32, one partial sum per fixed slice of
//       the points: a CTA owns one product's whole output for one slice.
//   tensorf_mlp_reduce_kernel  adds the slices in a fixed order into the
//       gradients in the plain layout (W1's rows from the slots, the stored
//       columns undone).
//
// No atomics, and the slices are a fixed function of P, so two launches on
// the same inputs give bit-identical gradients.
//
// What bounds it: its bytes. The fused kernel reads the products and drgb
// and writes dprods, 1,164 bytes a point (0.35 ns at 3.35 TB/s), and does
// 86,016 multiply-adds on the tensor cores with the kernels' padding (0.17
// ns at 989 TFLOP/s); the scratch adds 1,712 bytes written and read again
// (1.02 ns), and the weight gradients 42,496 multiply-adds a point (0.09
// ns). The scratch is the price of the weight gradients: their 42,496 fp32
// sums, with the weights, fit neither one SM's registers nor its 227 KB of
// shared memory, so no block can carry them over its points; the scratch
// in bf16 is what their products read in any case. What the design does
// about the bytes:
//   * The forward is recomputed rather than stored, and every activation
//     and gradient stays in registers from one product to the next (8 warps
//     a block, one block an SM: the sweep holds ~250 registers a thread;
//     with more warps it spilled and ran slower).
//   * The scratch and dprods leave through a staging buffer of each warp in
//     shared memory as TMA bulk stores, one a row, which run on while the
//     warp computes (as 8- and 16-byte stores from the registers they held
//     up the warps: ~40% of the kernel's time); the features a wait in
//     shared memory for the sweep.
//   * The weight gradients read the scratch back as 16-byte cp.async loads
//     in a 3-stage ring, at ~60% of its read floor.

#include "tensorf_mlp_common.cuh"

namespace tfm = tensorf_mlp;

namespace {

constexpr int BWD_WARPS = 8;

struct BwdArgs {
  const float* prods;  // [P, 144]
  const float* dirs;   // [N, 3]
  const uint2* image;
  const float *b1, *b2, *b3;
  long long p;
  int s;
  const float* drgb;   // [P, 3]
  float* dprods;       // [P, 144]
  __nv_bfloat16* scratch;  // [SCRATCH_COLS * P]: block b at block_offset(b) * P
};

__device__ __forceinline__ __nv_bfloat16* block_ptr(const BwdArgs& a, int b) {
  return a.scratch + (long long)tfm::block_offset(b) * a.p;
}

// A warp's stores of a group's 16 rows: each scratch matrix, made k-step by
// k-step as A fragments (both rows' four values of a lane, 8 bytes a row in
// the stored order), goes to the warp's staging buffer, rows padded by 16
// bytes so that the 8-byte stores meet no bank twice; flush() then hands
// its rows to TMA bulk stores, one a row from lanes 0-15, which run on while
// the warp computes (begin() of the next matrix waits until they have read
// the buffer). The features a go to the warp's shared memory until the
// reverse sweep reads them (they would hold 16 registers through it).
constexpr int FEAT_BYTES = 16 * 32 * 4;                // a warp's features
constexpr int STG_BYTES = 16 * (2 * tfm::SLOTS + 16);  // a warp's staging: X0's rows, the widest
constexpr int DP_COLS = 48;                            // products' gradients staged a time
static_assert(16 * (4 * DP_COLS + 16) <= STG_BYTES, "");

struct Store {
  const BwdArgs* a;
  tfm::Rows r;
  float* feat;         // [16][32 lanes]
  unsigned char* stg;  // the staging buffer
  __device__ __forceinline__ void begin(int) const {
    tfm::bulk_wait_read();
    __syncwarp();
  }
  __device__ __forceinline__ void operator()(int b, int kk, const uint32_t (&x)[4]) const {
    const int pitch = 2 * tfm::block_cols(b) + 16, g = r.lane >> 2;
    unsigned char* p = stg + 2 * (16 * kk + 4 * r.t);
    *reinterpret_cast<uint2*>(p + g * pitch) = make_uint2(x[0], x[2]);
    *reinterpret_cast<uint2*>(p + (g + 8) * pitch) = make_uint2(x[1], x[3]);
  }
  // rows of `bytes` each at dst + row * stride, from the staging rows
  __device__ __forceinline__ void rows_out(char* dst, long long stride, int bytes) const {
    tfm::fence_async_shared();
    __syncwarp();
    const long long row = r.first + r.lane;
    if (r.lane < 16 && row < a->p) {
      tfm::bulk_store(dst + row * stride, stg + r.lane * (bytes + 16), bytes);
      tfm::bulk_commit();
    }
  }
  __device__ __forceinline__ void flush(int b) const {
    const int bytes = 2 * tfm::block_cols(b);
    rows_out(reinterpret_cast<char*>(block_ptr(*a, b)), bytes, bytes);
  }
  __device__ __forceinline__ void features(const float (&v)[4][4]) const {
#pragma unroll
    for (int e = 0; e < 16; ++e) feat[32 * e + r.lane] = v[e / 4][e % 4];
  }
};

constexpr int BWD_SMEM = tfm::ALL_BYTES + BWD_WARPS * (FEAT_BYTES + STG_BYTES);
static_assert(BWD_SMEM + 16 <= 232448, "above the shared memory of one block");

__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
tensorf_mlp_bwd_kernel(const __grid_constant__ BwdArgs a) {
  using namespace tfm;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  stage_image(smem, a.image, ALL_BYTES, &bar);
  const uint2* w = reinterpret_cast<const uint2*>(smem);
  const Weights wt{w, a.b1, a.b2, a.b3};
  const long long groups = (a.p + 15) / 16;
  const int warp = threadIdx.x >> 5;
  float* feat = reinterpret_cast<float*>(smem + ALL_BYTES + warp * FEAT_BYTES);
  unsigned char* stg = smem + ALL_BYTES + BWD_WARPS * FEAT_BYTES + warp * STG_BYTES;
  for (long long grp = (long long)blockIdx.x * BWD_WARPS + warp; grp < groups;
       grp += (long long)gridDim.x * BWD_WARPS) {
    const Rows r = rows_of(grp, a.p);
    const Store keep{&a, r, feat, stg};
    float sg[4];
    uint32_t mask1[4], mask2[4];
    forward_rows(a.prods, a.dirs, a.s, wt, r, mask1, mask2, sg, keep);

    // dz3 = drgb * (1 - s) * s at columns 2 t, 2 t + 1 (0 past blue)
    float dz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 2 * r.t + (i & 1);
      const long long row = i < 2 ? r.r0 : r.r1;
      const bool v = (i < 2 ? r.v0 : r.v1) && c < RGB;
      const float g = v ? __ldg(a.drgb + 3 * row + c) : 0.f;
      dz[i] = g * (1.f - sg[i]) * sg[i];
    }
    uint32_t g3[1][4] = {{pack2(dz[0], dz[1]), pack2(dz[2], dz[3]), 0u, 0u}};
    {
      __nv_bfloat16* base = block_ptr(a, G3) + 2 * r.t;
      if (r.v0) *reinterpret_cast<uint32_t*>(base + r.r0 * 8) = g3[0][0];
      if (r.v1) *reinterpret_cast<uint32_t*>(base + r.r1 * 8) = g3[0][1];
    }
    // dz2 = (dz3 W3^T) where the second layer's sum was above 0
    uint32_t g2[8][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float acc[4][4];
      zero(acc);
      mma_range<1, 4, 1, 16>(acc, g3, w, OFF_W3T, 0, 4 * m, r.lane);
      masked_quarter(acc, mask2[m], m, g2);
    }
    keep.begin(G2);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) keep(G2, kk, g2[kk]);
    keep.flush(G2);
    // dz1 = (dz2 W2^T) where the first layer's sum was above 0
    uint32_t g1[8][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float acc[4][4];
      zero(acc);
      mma_range<8, 4, 8, 16>(acc, g2, w, OFF_W2T, 0, 4 * m, r.lane);
      masked_quarter(acc, mask1[m], m, g1);
    }
    keep.begin(G1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) keep(G1, kk, g1[kk]);
    keep.flush(G1);
    // da: dh0 = dz1 W1^T over copy q's 4 n-tiles (slots 32 q ..), through
    // the encodings: a, then sin(a) and cos(a), then sin(2a) and cos(2a)
    float da[4][4];
    zero(da);
    mma_range<8, 4, 8, 20>(da, g1, w, OFF_W1T, 0, 0, r.lane);
#pragma unroll
    for (int q = 1; q < 5; ++q) {  // sin(a), sin(2a), cos(a), cos(2a)
      float acc[4][4];
      zero(acc);
      mma_range<8, 4, 8, 20>(acc, g1, w, OFF_W1T, 0, 4 * q, r.lane);
      const float scale = q % 2 ? 1.f : 2.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float sn, cs;
        sin_cos(feat[32 * e + r.lane] * scale, sn, cs);
        da[e / 4][e % 4] += acc[e / 4][e % 4] * (q < 3 ? cs : -sn) * scale;
      }
    }
    uint32_t ga[2][4];
    keep.begin(GA);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ga[hh][0] = pack2(da[2 * hh][0], da[2 * hh][1]);
      ga[hh][1] = pack2(da[2 * hh][2], da[2 * hh][3]);
      ga[hh][2] = pack2(da[2 * hh + 1][0], da[2 * hh + 1][1]);
      ga[hh][3] = pack2(da[2 * hh + 1][2], da[2 * hh + 1][3]);
      keep(GA, hh, ga[hh]);
    }
    keep.flush(GA);
    // dprods = da basis^T, 48 columns a time through the staging buffer
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      float acc[6][4];
      zero(acc);
      mma_range<2, 6, 2, 18>(acc, ga, w, OFF_BAST, 0, 6 * part, r.lane);
      keep.begin(0);
      constexpr int pitch = 4 * DP_COLS + 16;
      float* row0 = reinterpret_cast<float*>(stg + (r.lane >> 2) * pitch);
      float* row1 = reinterpret_cast<float*>(stg + ((r.lane >> 2) + 8) * pitch);
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) {
        const int col = 16 * pp + 4 * r.t;
        *reinterpret_cast<float4*>(row0 + col) =
            make_float4(acc[2 * pp][0], acc[2 * pp][1], acc[2 * pp + 1][0], acc[2 * pp + 1][1]);
        *reinterpret_cast<float4*>(row1 + col) =
            make_float4(acc[2 * pp][2], acc[2 * pp][3], acc[2 * pp + 1][2], acc[2 * pp + 1][3]);
      }
      keep.rows_out(reinterpret_cast<char*>(a.dprods + DP_COLS * part), 4 * PROD, 4 * DP_COLS);
    }
  }
  bulk_wait();  // the stores done before the block ends
}

// ------------------------------------------------------ weight gradients

// the four products: X block, its width K; G block, its width N; whether the
// G's column sums (a bias's gradient) are taken; the warps' arrangement WM x
// WN over m-tiles (interleaved) and n-tiles (in runs); where a slice's
// partial sums of out and of the bias go
constexpr int J_OUT0 = 0, J_OUT1 = J_OUT0 + tfm::SLOTS * tfm::WIDTH,
              J_OUT2 = J_OUT1 + tfm::WIDTH * tfm::WIDTH, J_OUT3 = J_OUT2 + tfm::WIDTH * 8,
              B_OUT0 = J_OUT3 + tfm::PROD * 32, B_OUT1 = B_OUT0 + tfm::WIDTH,
              B_OUT2 = B_OUT1 + tfm::WIDTH, PARTIAL = B_OUT2 + 8;  // 42,760 floats a slice
template <int J> struct Job;
template <> struct Job<0> {  // dW1 [160 slots, 128], db1
  static constexpr int x = tfm::X0, k = tfm::SLOTS, g = tfm::G1, n = tfm::WIDTH, bias = 1, wm = 2,
                       wn = 4, out = J_OUT0, bout = B_OUT0;
};
template <> struct Job<1> {  // dW2 [128, 128], db2
  static constexpr int x = tfm::X1, k = tfm::WIDTH, g = tfm::G2, n = tfm::WIDTH, bias = 1, wm = 2,
                       wn = 4, out = J_OUT1, bout = B_OUT1;
};
template <> struct Job<2> {  // dW3 [128, 8], db3
  static constexpr int x = tfm::X2, k = tfm::WIDTH, g = tfm::G3, n = 8, bias = 1, wm = 8, wn = 1,
                       out = J_OUT2, bout = B_OUT2;
};
template <> struct Job<3> {  // dbasis [144, 32]
  static constexpr int x = tfm::XP, k = tfm::PROD, g = tfm::GA, n = 32, bias = 0, wm = 8, wn = 1,
                       out = J_OUT3, bout = 0;
};
constexpr int WG_THREADS = 256, WG_POINTS = 32, WG_STAGES = 3;
__host__ __device__ constexpr int lds(int width) { return width + 8; }  // ldmatrix conflict-free
template <int J> constexpr int stage_elems() {
  return WG_POINTS * (lds(Job<J>::k) + lds(Job<J>::n));
}
constexpr int WG_SMEM = WG_STAGES * stage_elems<0>() * 2;  // job 0's stages are the largest
static_assert(stage_elems<0>() >= stage_elems<1>() && stage_elems<0>() >= stage_elems<2>() &&
                  stage_elems<0>() >= stage_elems<3>(), "");

struct WgradArgs {
  const __nv_bfloat16* scratch;
  long long p;
  int chunk;       // points a slice, a multiple of WG_POINTS
  float* partial;  // [slices, PARTIAL]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tfm::saddr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// four (two) 8 x 8 b16 matrices from shared memory, each transposed; lane l
// gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldm4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tfm::saddr(row)));
}

__device__ __forceinline__ void ldm2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(tfm::saddr(row)));
}

// One CTA: job J's out[k, n] over the points [p0, p1) of its slice. The
// operands' 32-point stages arrive by cp.async (rows past p1 zero-filled);
// warp (wm, wn) sums m-tiles wm, wm + WM, .. against n-tiles wn NJ .. + NJ,
// A = X^T and B = G both by ldmatrix.trans from the point-major stages.
template <int J>
__device__ __forceinline__ void wgrad_job(const WgradArgs& a, unsigned char* smem, long long p0,
                                          long long p1, float* part) {
  using jb = Job<J>;
  constexpr int K = jb::k, N = jb::n, LX = lds(K), LG = lds(N);
  constexpr int MT = K / 16, NT = N / 8, MI = (MT + jb::wm - 1) / jb::wm, NJ = NT / jb::wn;
  constexpr int STAGE = WG_POINTS * (LX + LG);
  constexpr int XC = K / 8, GC = N / 8;  // 16-byte chunks a row
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* xs = a.scratch + (long long)tfm::block_offset(jb::x) * a.p;
  const __nv_bfloat16* gs = a.scratch + (long long)tfm::block_offset(jb::g) * a.p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / jb::wn, wn = warp % jb::wn;
  const int stages = (int)((p1 - p0 + WG_POINTS - 1) / WG_POINTS);

  auto load = [&](int st) {
    if (st < stages) {
      __nv_bfloat16* dst = ring + (st % WG_STAGES) * STAGE;
      const long long base = p0 + (long long)st * WG_POINTS;
      for (int c = tid; c < WG_POINTS * (XC + GC); c += WG_THREADS) {
        const bool isx = c < WG_POINTS * XC;
        const int cc = isx ? c : c - WG_POINTS * XC, row = cc / (isx ? XC : GC);
        const int piece = cc % (isx ? XC : GC);
        const long long pt = base + row;
        const bool ok = pt < p1;
        const __nv_bfloat16* src = (isx ? xs + (ok ? pt : p0) * K : gs + (ok ? pt : p0) * N) +
                                   8 * piece;
        __nv_bfloat16* d = isx ? dst + row * LX + 8 * piece
                               : dst + WG_POINTS * LX + row * LG + 8 * piece;
        cp_async16(d, src, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  float bsum[2] = {0.f, 0.f};

#pragma unroll
  for (int st = 0; st < WG_STAGES - 1; ++st) load(st);
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WG_STAGES - 2) : "memory");
    __syncthreads();
    load(st + WG_STAGES - 1);
    const __nv_bfloat16* X = ring + (st % WG_STAGES) * STAGE;
    const __nv_bfloat16* G = X + WG_POINTS * LX;
#pragma unroll
    for (int ks = 0; ks < WG_POINTS / 16; ++ks) {
      const int q = lane >> 3, rr = lane & 7;
      uint32_t b[NJ][2];
      if constexpr (NJ == 1) {
        uint32_t t2[2];
        ldm2(t2, G + (16 * ks + rr + 8 * (q & 1)) * LG + 8 * (wn * NJ));
        b[0][0] = t2[0];
        b[0][1] = t2[1];
      } else {
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t t4[4];
          ldm4(t4, G + (16 * ks + rr + 8 * (q & 1)) * LG + 8 * (wn * NJ + 2 * jj) +
                            8 * (q >> 1));
          b[2 * jj][0] = t4[0];
          b[2 * jj][1] = t4[1];
          b[2 * jj + 1][0] = t4[2];
          b[2 * jj + 1][1] = t4[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int mt = wm + jb::wm * mi;
        if (mt < MT) {
          uint32_t x[4];
          ldm4(x, X + (16 * ks + rr + 8 * (q >> 1)) * LX + 16 * mt + 8 * (q & 1));
#pragma unroll
          for (int j = 0; j < NJ; ++j) tfm::mma(acc[mi][j], x, make_uint2(b[j][0], b[j][1]));
        }
      }
    }
    if (jb::bias && tid < N / 2) {  // the column sums, a fixed order of the points
#pragma unroll 8
      for (int pt = 0; pt < WG_POINTS; ++pt) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(G + pt * LG + 2 * tid);
        bsum[0] += __low2float(v);
        bsum[1] += __high2float(v);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int mt = wm + jb::wm * mi;
    if (mt < MT) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * (wn * NJ + j) + 2 * t;
        *reinterpret_cast<float2*>(part + jb::out + (16 * mt + g) * N + col) =
            make_float2(acc[mi][j][0], acc[mi][j][1]);
        *reinterpret_cast<float2*>(part + jb::out + (16 * mt + g + 8) * N + col) =
            make_float2(acc[mi][j][2], acc[mi][j][3]);
      }
    }
  }
  if (jb::bias && tid < N / 2)
    *reinterpret_cast<float2*>(part + jb::bout + 2 * tid) = make_float2(bsum[0], bsum[1]);
}

__global__ void __launch_bounds__(WG_THREADS, 2)
tensorf_mlp_wgrad_kernel(const __grid_constant__ WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long p0 = (long long)blockIdx.x * a.chunk;
  const long long p1 = p0 + a.chunk < a.p ? p0 + a.chunk : a.p;
  float* part = a.partial + (long long)blockIdx.x * PARTIAL;
  switch (blockIdx.y) {
    case 0: wgrad_job<0>(a, smem, p0, p1, part); break;
    case 1: wgrad_job<1>(a, smem, p0, p1, part); break;
    case 2: wgrad_job<2>(a, smem, p0, p1, part); break;
    default: wgrad_job<3>(a, smem, p0, p1, part); break;
  }
}

// the gradients in the plain layout, one flat fp32 buffer: basis [144, 27],
// W1 [150, 128], b1 [128], W2 [128, 128], b2 [128], W3 [128, 3], b3 [3]
constexpr int O_BASIS = 0, O_W1 = O_BASIS + tfm::PROD * tfm::APP, O_B1 = O_W1 + tfm::IN * tfm::WIDTH,
              O_W2 = O_B1 + tfm::WIDTH, O_B2 = O_W2 + tfm::WIDTH * tfm::WIDTH,
              O_W3 = O_B2 + tfm::WIDTH, O_B3 = O_W3 + tfm::WIDTH * tfm::RGB, OUT = O_B3 + tfm::RGB;

// partial-sum index of output element e
__device__ __forceinline__ int source_of(int e) {
  using tfm::phys;
  if (e < O_W1) {  // dbasis [k, c]: XP in the products' order, GA in the stored order
    const int k = e / tfm::APP, c = e % tfm::APP;
    return J_OUT3 + k * 32 + phys(c);
  }
  if (e < O_B1) {
    const int r = (e - O_W1) / tfm::WIDTH, n = (e - O_W1) % tfm::WIDTH;
    return J_OUT0 + phys(tfm::slot_of(r)) * tfm::WIDTH + phys(n);
  }
  if (e < O_W2) return B_OUT0 + phys(e - O_B1);
  if (e < O_B2) {
    const int r = (e - O_W2) / tfm::WIDTH, n = (e - O_W2) % tfm::WIDTH;
    return J_OUT1 + phys(r) * tfm::WIDTH + phys(n);
  }
  if (e < O_W3) return B_OUT1 + phys(e - O_B2);
  if (e < O_B3) {  // G3 in the natural order
    const int r = (e - O_W3) / tfm::RGB, n = (e - O_W3) % tfm::RGB;
    return J_OUT2 + phys(r) * 8 + n;
  }
  return B_OUT2 + (e - O_B3);
}

__global__ void __launch_bounds__(256)
tensorf_mlp_reduce_kernel(const float* __restrict__ partial, int slices, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= OUT) return;
  const float* src = partial + source_of(e);
  float s = 0.f;
  for (int i = 0; i < slices; ++i) s += __ldg(src + (long long)i * PARTIAL);
  out[e] = s;
}

}  // namespace

// The sizes the wrapper allocates: the scratch's bf16 columns a point, the
// partial sums' floats a slice and the gradients' floats.
extern "C" void tensorf_mlp_bwd_sizes(int* scratch_cols, int* partial, int* out) {
  *scratch_cols = tfm::SCRATCH_COLS;
  *partial = PARTIAL;
  *out = OUT;
}

// From the forward's inputs, the image its call packed and drgb [p, 3]:
// dprods [p, 144] and the flat gradients out [OUT] (tensorf_mlp_bwd_sizes),
// through scratch [SCRATCH_COLS * p] bf16 and partial [slices * PARTIAL]
// fp32, slices of `chunk` points (a multiple of 32; slices * chunk >= p >
// (slices - 1) * chunk). Returns 0, a cudaError_t value if a launch failed,
// or -1 for sizes the kernels do not take.
extern "C" int tensorf_mlp_bwd(const void* prods, const void* dirs, long long p, int s,
                               const void* image, const void* b1, const void* b2, const void* b3,
                               const void* drgb, void* dprods, void* scratch, void* partial,
                               int slices, int chunk, void* out, void* stream) {
  if (p < 1 || p > 0x7fffffffLL || s < 1 || chunk < 1 || chunk % WG_POINTS != 0 || slices < 1 ||
      (long long)slices * chunk < p || (long long)(slices - 1) * chunk >= p)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(tensorf_mlp_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tensorf_mlp_wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const BwdArgs ba{static_cast<const float*>(prods), static_cast<const float*>(dirs),
                   static_cast<const uint2*>(image), static_cast<const float*>(b1),
                   static_cast<const float*>(b2), static_cast<const float*>(b3), p, s,
                   static_cast<const float*>(drgb), static_cast<float*>(dprods),
                   static_cast<__nv_bfloat16*>(scratch)};
  const long long need = ((p + 15) / 16 + BWD_WARPS - 1) / BWD_WARPS;
  tensorf_mlp_bwd_kernel<<<(unsigned)(need < sms ? need : sms), BWD_WARPS * 32, BWD_SMEM, st>>>(
      ba);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const WgradArgs wa{static_cast<const __nv_bfloat16*>(scratch), p, chunk,
                     static_cast<float*>(partial)};
  tensorf_mlp_wgrad_kernel<<<dim3((unsigned)slices, 4), WG_THREADS, WG_SMEM, st>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tensorf_mlp_reduce_kernel<<<(OUT + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                               slices, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
