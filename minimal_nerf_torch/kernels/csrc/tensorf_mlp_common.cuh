// TensoRF's shading chain (Chen et al., TensoRF: Tensorial Radiance Fields,
// ECCV 2022, sec. 4: MLPRender_Fea at configs/lego.txt's sizes), shared by
// tensorf_mlp_fwd.cu and tensorf_mlp_bwd.cu: the appearance products [P, 144]
// through the basis [144, 27] to the features a, the first layer's input
// [a, d, sin/cos(a 2^f), sin/cos(d 2^f)] (150 columns; d the unit view
// direction of the point's ray, f = 0, 1), then 150 -> 128 -> 128 -> 3 with
// ReLU, ReLU, sigmoid. Every product's inputs are rounded to bf16 and summed
// in fp32 on the tensor cores (mma.sync m16n8k16); the biases, the sines,
// the sigmoid and every gradient's arithmetic outside the products are fp32.
// The plain version is kernels/tensorf_mlp.py::mlp_plain.
//
// No TPU kernel stands behind these: the JAX package has no TensoRF. They
// replace the plain chain's ~40 PyTorch launches a pass (bf16 round trips of
// every product's operands, fp32 SIMT GEMMs, the 150-wide concatenation, the
// sines and their backwards), which paced the train step.
//
// Layout. A warp owns 16 points (rows) at a time and keeps them in
// registers through the whole chain: a layer's fp32 accumulators (the mma's
// C fragments) are rounded and packed straight into the next layer's A
// fragments, so no activation goes through shared or device memory. The
// products are mma.sync, not wgmma: the chain's layers are 128 wide and do
// 145 operations a byte of the points' own traffic, half the card's ridge,
// so the tensor cores' rate does not bound it, while a warp's own 16 rows
// need no barrier with other warps between layers. The
// weights are packed once a call (tensorf_mlp_pack_kernel) as bf16 B
// fragments, uint2[k-step][n-tile][32 lanes], and copied whole into each
// block's shared memory by TMA bulk copies; a lane reads its fragment of a
// (k-step, n-tile) as one conflict-free 8-byte load.
//
// The first layer's 150 inputs sit in SLOTS = 160 slots, 5 copies of 32:
// copy q holds a (q 0), sin(a) (1), sin(2a) (2), cos(a) (3), cos(2a) (4) at
// slot 32 q + c for feature c < 27. The lane that holds feature c of a (the
// basis product's C fragment) also holds every slot 32 q + c of the A
// fragments, so the encodings need no exchange between lanes. The 15 view
// inputs (d, sin(d 2^f), cos(d 2^f) in the plain order) take the spare slots
// 32 q + 27 .. 31 of copies 0-2; copies 3 and 4 keep theirs at 0.
// plain_row() maps a slot to its row of W1 (-1: none).
//
// Stored columns: where a lane's four values of a 16-column k-step go to
// device memory (the backward's scratch, the products' gradient), logical
// column 16 m + 2 t + i sits at 16 m + 4 t + i and 16 m + 8 + 2 t + i at
// 16 m + 4 t + 2 + i (phys()), so a lane writes 8 or 16 contiguous bytes a
// row. The products are read the same way as float4s, so the basis's rows
// are packed in that order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tensorf_mlp {

constexpr int PROD = 144;   // appearance products a point (3 modes x 48)
constexpr int APP = 27;     // appearance features (app_dim)
constexpr int WIDTH = 128;  // feature_width
constexpr int IN = 150;     // the first layer's inputs
constexpr int SLOTS = 160;  // the first layer's inputs in the kernels' order
constexpr int RGB = 3;

// The packed image: each matrix B [K, N] as uint2[K / 16][N / 8][32], its
// offset in uint2. The forward's four, then the backward's transposes.
constexpr int frags(int ks, int nt) { return ks * nt * 32; }
constexpr int OFF_BAS = 0;                              // basis [144, 32]
constexpr int OFF_W1 = OFF_BAS + frags(9, 4);           // W1 [160 slots, 128]
constexpr int OFF_W2 = OFF_W1 + frags(10, 16);          // W2 [128, 128]
constexpr int OFF_W3 = OFF_W2 + frags(8, 16);           // W3 [128, 8]
constexpr int FWD_FRAGS = OFF_W3 + frags(8, 1);
constexpr int OFF_W3T = FWD_FRAGS;                      // W3^T [16, 128]
constexpr int OFF_W2T = OFF_W3T + frags(1, 16);         // W2^T [128, 128]
constexpr int OFF_W1T = OFF_W2T + frags(8, 16);         // W1^T [128, 160 slots]
constexpr int OFF_BAST = OFF_W1T + frags(8, 20);        // basis^T [32, 144]
constexpr int ALL_FRAGS = OFF_BAST + frags(2, 18);
constexpr int FWD_BYTES = FWD_FRAGS * 8;                // 84,992
constexpr int ALL_BYTES = ALL_FRAGS * 8;                // 172,032
static_assert(FWD_BYTES % 16 == 0 && ALL_BYTES % 16 == 0, "bulk copies move 16-byte units");

// the backward's scratch: one bf16 matrix [P, width] each, in this order
enum { X0, XP, X1, X2, G1, G2, G3, GA, BLOCKS };
__host__ __device__ constexpr int block_cols(int b) {
  return b == X0 ? SLOTS : (b == XP ? PROD : (b == G3 ? 8 : (b == GA ? 32 : WIDTH)));
}
__host__ __device__ constexpr int block_offset(int b) {  // columns before block b
  int s = 0;
  for (int i = 0; i < b; ++i) s += block_cols(i);
  return s;
}
constexpr int SCRATCH_COLS = block_offset(BLOCKS);  // 856
static_assert(SCRATCH_COLS == 856, "");

// ------------------------------------------------------------- the layout

// stored column of logical column l (module note)
__host__ __device__ constexpr int phys(int l) {
  const int r = l & 15, base = l - r;
  return base + (r < 8 ? 4 * (r >> 1) + (r & 1) : 4 * ((r - 8) >> 1) + 2 + (r & 1));
}

// W1's row (the plain version's input column) of a slot, or -1
__host__ __device__ constexpr int plain_row(int slot) {
  const int q = slot >> 5, c = slot & 31;
  if (c < APP) return q == 0 ? c : (q <= 2 ? 30 + 2 * c + (q - 1) : 84 + 2 * c + (q - 3));
  if (q >= 3) return -1;
  const int e = 5 * q + c - APP;  // the view input: d0-d2, sin(d 2^f), cos(d 2^f)
  return e < 3 ? APP + e : 135 + e;
}

// the slot of W1's row r (plain_row's inverse)
__host__ __device__ constexpr int slot_of(int r) {
  if (r < APP) return r;
  if (r < 30 || r >= 138) {
    const int e = r < 30 ? r - APP : r - 135;
    return 32 * (e / 5) + APP + e % 5;
  }
  const int u = r < 84 ? r - 30 : r - 84, q = (r < 84 ? 1 : 3) + (u & 1);
  return 32 * q + (u >> 1);
}

// ------------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two fp32 values as bf16x2, the first in the low half (ReLU first with
// RELU: the same bits as rounding after fmaxf)
template <bool RELU = false>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A waits ~10 s (2^34 cycles) only on a fault of the copy: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Bulk stores from shared to device memory (TMA, tracked per issuing
// thread): the copy, its group's commit, the waits until the groups have
// read their shared memory or are done; the fence that orders this
// thread's generic stores to shared memory before a copy reads them.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(saddr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The packed image's first `bytes` into shared memory at w by TMA bulk
// copies from one thread, every thread waiting on bar for their bytes.
__device__ __forceinline__ void stage_image(void* w, const void* image, int bytes,
                                            uint64_t* bar) {
  const uint32_t b = saddr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
    constexpr int CHUNK = 16384;
    for (int off = 0; off < bytes; off += CHUNK) {
      const int n = bytes - off < CHUNK ? bytes - off : CHUNK;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(saddr(static_cast<char*>(w) + off)),
          "l"(static_cast<const char*>(image) + off), "r"(n), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier initialised before anyone waits on it
  mbar_wait(b, 0);
}

// ------------------------------------------------------------ the warp's rows

// A lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of its warp's
// 16: in a C fragment c[0], c[1] at row g, columns 8 j + 2 t + {0, 1} of
// n-tile j, and c[2], c[3] at row g + 8; in an A fragment of k-step kk, a[0]
// (row g) and a[1] (row g + 8) at columns 16 kk + 2 t + {0, 1}, a[2] and a[3]
// at 16 kk + 8 + 2 t + {0, 1}.
struct Rows {
  long long first;   // the group's first point
  long long r0, r1;  // the two rows' points
  bool v0, v1;       // below P
  int lane, t;
};

__device__ __forceinline__ Rows rows_of(long long group, long long p) {
  Rows r;
  r.lane = threadIdx.x & 31;
  r.t = r.lane & 3;
  r.first = 16 * group;
  r.r0 = r.first + (r.lane >> 2);
  r.r1 = r.r0 + 8;
  r.v0 = r.r0 < p;
  r.v1 = r.r1 < p;
  return r;
}

// B fragment of (k-step kk, n-tile j) of a packed matrix with nt n-tiles,
// loaded where it is written: volatile, so that the compiler keeps it in
// order with the products (asm volatile too) and does not hoist a layer's
// fragments into registers all at once
__device__ __forceinline__ uint2 frag(const uint2* w, int off, int nt, int kk, int j, int lane) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(saddr(w + off + (kk * nt + j) * 32 + lane)));
  return v;
}

// acc[j] (+)= x[k0 .. k0 + KS) @ B[.., n0 + j] for j < NJ, each k-step's
// fragments loaded while the last k-step's products run
template <int KS, int NJ, int K, int NT>
__device__ __forceinline__ void mma_range(float (&acc)[NJ][4], const uint32_t (&x)[K][4],
                                          const uint2* w, int off, int k0, int n0, int lane) {
  uint2 b[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[0][j] = frag(w, off, NT, k0, n0 + j, lane);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk + 1 < KS) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[(kk + 1) & 1][j] = frag(w, off, NT, k0 + kk + 1, n0 + j, lane);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(acc[j], x[k0 + kk], b[kk & 1][j]);
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// This lane's products as the basis product's A fragments: per k-step the
// float4s of columns 16 kk + 4 t .. + 3 of both rows, in the stored order
// (module note); rows past P read as zeros.
__device__ __forceinline__ void load_prods(const float* __restrict__ prods, const Rows& r,
                                           uint32_t (&pa)[9][4]) {
  const float4* p0 = reinterpret_cast<const float4*>(prods + r.r0 * PROD) + r.t;
  const float4* p1 = reinterpret_cast<const float4*>(prods + r.r1 * PROD) + r.t;
  float4 v[9][2];
#pragma unroll
  for (int kk = 0; kk < 9; ++kk) {
    v[kk][0] = r.v0 ? __ldg(p0 + 4 * kk) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[kk][1] = r.v1 ? __ldg(p1 + 4 * kk) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < 9; ++kk) {
    pa[kk][0] = pack2(v[kk][0].x, v[kk][0].y);
    pa[kk][1] = pack2(v[kk][1].x, v[kk][1].y);
    pa[kk][2] = pack2(v[kk][0].z, v[kk][0].w);
    pa[kk][3] = pack2(v[kk][1].z, v[kk][1].w);
  }
}

// sin and cos of x in fp32: x reduced to [-pi, pi] by a two-part 2 pi (Cody
// and Waite), then the SFU's __sincosf, within 2^-21.4 of the exact values
// there, far below the bf16 rounding (2^-9) of the encodings
__device__ __forceinline__ void sin_cos(float x, float& s, float& c) {
  const float k = rintf(x * 0.159154943091895336f);
  float r = fmaf(-k, 6.28318548202514648f, x);
  r = fmaf(-k, -1.74845553e-7f, r);
  __sincosf(r, &s, &c);
}

// the unit view direction of a point's ray (its S samples share it)
__device__ __forceinline__ void unit_dir(const float* __restrict__ dirs, long long row, bool valid,
                                         int s, float (&d)[3]) {
  if (!valid) {
    d[0] = d[1] = d[2] = 0.f;
    return;
  }
  const float* v = dirs + 3 * (long long)((unsigned)row / (unsigned)s);  // P < 2^31
  const float x = __ldg(v), y = __ldg(v + 1), z = __ldg(v + 2);
  const float n = sqrtf(x * x + y * y + z * z);
  d[0] = x / n;
  d[1] = y / n;
  d[2] = z / n;
}

// view input e (plain order: d0-d2, sin(d_c 2^f) at 3 + 2 c + f, cos at 9 + 2 c + f)
__device__ __forceinline__ float view_input(int e, const float (&d)[3]) {
  if (e < 3) return e == 0 ? d[0] : (e == 1 ? d[1] : d[2]);
  const int u = e < 9 ? e - 3 : e - 9, c = u >> 1;
  const float x = (c == 0 ? d[0] : (c == 1 ? d[1] : d[2])) * (u & 1 ? 2.f : 1.f);
  float sn, cs;
  sin_cos(x, sn, cs);
  return e < 9 ? sn : cs;
}

// The first layer's A fragments h[10][4] from the features a (the basis
// product's C fragments, 4 n-tiles) and both rows' view directions. Slot
// 32 q + c of feature c < 27 is a's copy q; the spare slots take the view
// inputs (module note).
__device__ __forceinline__ void first_input(const float (&a)[4][4], const float (&d0)[3],
                                            const float (&d1)[3], int t, uint32_t (&h)[10][4]) {
  // n-tile j of a holds features 8 j + 2 t + {0, 1}: in copy q they go to
  // k-step 2 q + j / 2, registers 2 (j % 2) + {0, 1}
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float enc[5][4];  // [copy][element]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = a[j][i];
      enc[0][i] = v;
      sin_cos(v, enc[1][i], enc[3][i]);
      sin_cos(v * 2.f, enc[2][i], enc[4][i]);
      const int c = 8 * j + 2 * t + (i & 1);
      if (j == 3 && c >= APP) {  // features 27-31 (lanes t >= 1): the view inputs or 0
#pragma unroll
        for (int q = 0; q < 5; ++q)
          enc[q][i] = q < 3 ? view_input(5 * q + c - APP, i < 2 ? d0 : d1) : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int kk = 2 * q + j / 2, r = 2 * (j % 2);
      h[kk][r] = pack2(enc[q][0], enc[q][1]);
      h[kk][r + 1] = pack2(enc[q][2], enc[q][3]);
    }
  }
}

// A quarter (n-tiles 4 m .. 4 m + 3) of a 128-wide layer: bias, then ReLU,
// rounded to bf16 as k-steps 2 m, 2 m + 1 of the next layer's A fragments;
// mask bit 4 j + i set where the sum plus bias is above 0 (ReLU's gradient).
__device__ __forceinline__ uint32_t relu_quarter(const float (&acc)[4][4],
                                                 const float* __restrict__ bias, int m, int t,
                                                 uint32_t (&y)[8][4]) {
  uint32_t mask = 0;
  float z[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * (4 * m + j) + 2 * t));
    z[j][0] = acc[j][0] + b.x;
    z[j][1] = acc[j][1] + b.y;
    z[j][2] = acc[j][2] + b.x;
    z[j][3] = acc[j][3] + b.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) mask |= (z[j][i] > 0.f ? 1u : 0u) << (4 * j + i);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    y[2 * m + hh][0] = pack2<true>(z[2 * hh][0], z[2 * hh][1]);
    y[2 * m + hh][1] = pack2<true>(z[2 * hh][2], z[2 * hh][3]);
    y[2 * m + hh][2] = pack2<true>(z[2 * hh + 1][0], z[2 * hh + 1][1]);
    y[2 * m + hh][3] = pack2<true>(z[2 * hh + 1][2], z[2 * hh + 1][3]);
  }
  return mask;
}

// A quarter of a gradient: acc (the product of the output gradient with W^T)
// where mask is set, else 0, rounded to bf16 as k-steps 2 m, 2 m + 1.
__device__ __forceinline__ void masked_quarter(const float (&acc)[4][4], uint32_t mask, int m,
                                               uint32_t (&y)[8][4]) {
  float z[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) z[j][i] = (mask >> (4 * j + i)) & 1u ? acc[j][i] : 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    y[2 * m + hh][0] = pack2(z[2 * hh][0], z[2 * hh][1]);
    y[2 * m + hh][1] = pack2(z[2 * hh][2], z[2 * hh][3]);
    y[2 * m + hh][2] = pack2(z[2 * hh + 1][0], z[2 * hh + 1][1]);
    y[2 * m + hh][3] = pack2(z[2 * hh + 1][2], z[2 * hh + 1][3]);
  }
}

// the sigmoid of the last layer's sum plus bias (fp32), at columns 2 t,
// 2 t + 1 of both rows (columns past 2 read 0.5, and carry no gradient)
__device__ __forceinline__ void sigmoid_out(const float (&acc)[4], const float* __restrict__ b3,
                                            int t, float (&s)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 2 * t + (i & 1);
    const float z = acc[i] + (c < RGB ? __ldg(b3 + c) : 0.f);
    s[i] = 1.f / (1.f + expf(-z));
  }
}

// The forward from the products to the sigmoid for this lane's rows: the
// ReLU masks of both hidden layers and the sigmoid s. keep(block, kk, x) is
// handed each layer's input A fragments of k-step kk as they are made (the
// backward's scratch: X0, X1, X2; and XP, the products), between
// keep.begin(block) and keep.flush(block); keep.features(a) the features a
// (the basis product's C fragments) once they are made.
struct Weights {
  const uint2* w;  // the packed image in shared memory
  const float *b1, *b2, *b3;
};

template <class Keep>
__device__ __forceinline__ void forward_rows(const float* __restrict__ prods,
                                             const float* __restrict__ dirs, int s,
                                             const Weights& wt, const Rows& r,
                                             uint32_t (&mask1)[4], uint32_t (&mask2)[4],
                                             float (&sg)[4], const Keep& keep) {
  const uint2* w = wt.w;
  float a[4][4];
  {
    uint32_t pa[9][4];
    load_prods(prods, r, pa);
    keep.begin(XP);
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) keep(XP, kk, pa[kk]);
    keep.flush(XP);
    zero(a);
    mma_range<9, 4, 9, 4>(a, pa, w, OFF_BAS, 0, 0, r.lane);
  }
  uint32_t h1[8][4];
  {
    uint32_t h0[10][4];
    float d0[3], d1[3];
    unit_dir(dirs, r.r0, r.v0, s, d0);
    unit_dir(dirs, r.r1, r.v1, s, d1);
    first_input(a, d0, d1, r.t, h0);
    keep.features(a);
    keep.begin(X0);
#pragma unroll
    for (int kk = 0; kk < 10; ++kk) keep(X0, kk, h0[kk]);
    keep.flush(X0);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float acc[4][4];
      zero(acc);
      mma_range<10, 4, 10, 16>(acc, h0, w, OFF_W1, 0, 4 * m, r.lane);
      mask1[m] = relu_quarter(acc, wt.b1, m, r.t, h1);
    }
  }
  keep.begin(X1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) keep(X1, kk, h1[kk]);
  keep.flush(X1);
  keep.begin(X2);
  float acc3[1][4];
  zero(acc3);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float acc[4][4];
    uint32_t h2[8][4];
    zero(acc);
    mma_range<8, 4, 8, 16>(acc, h1, w, OFF_W2, 0, 4 * m, r.lane);
    mask2[m] = relu_quarter(acc, wt.b2, m, r.t, h2);
    keep(X2, 2 * m, h2[2 * m]);
    keep(X2, 2 * m + 1, h2[2 * m + 1]);
    mma_range<2, 1, 8, 1>(acc3, h2, w, OFF_W3, 2 * m, 0, r.lane);
  }
  keep.flush(X2);
  sigmoid_out(acc3[0], wt.b3, r.t, sg);
}

}  // namespace tensorf_mlp
