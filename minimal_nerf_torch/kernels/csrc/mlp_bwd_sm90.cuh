// The dense layers of the bf16 fused backward's kernel A on Hopper (sm_90a),
// `fused_bwd_kernel_sm90` (fused_raymarch_bwd.cu): the forward recomputed
// with every layer's input and ReLU mask kept, and the reverse sweep, both on
// wgmma with TMA-staged weights, as mlp_fwd_sm90.cuh runs the forwards.
//
// It computes what mlp_forward<bf16, true> and reverse_sweep<bf16>
// (fused_raymarch_common.cuh) compute, with the same rounding points and the
// same scratch and mask contents: each layer's input (e, ed, a0..a5, h, r0)
// and output gradient (g_r0, g_h, g_a5..g_a0, the heads' block) in bf16, one
// matrix [points, width] per channel block; each ReLU layer's mask as bits,
// MASK_WORDS words a point. Only the sums inside a product run in another
// order.
//
// What bounds it: its stores (7,888 B of scratch and 208 B of mask bits a
// point, 2.42 ns at 3.35 TB/s) and its products (887,040 multiply-adds a
// point, 1.79 ns at 989 TFLOP/s). What the design does about that:
//   * Products on wgmma with fp32 sums in registers, two consumer
//     warpgroups of 64 rows each, every layer's bf16 output packed in
//     registers as the next layer's A operand, through the forward and the
//     reverse alike: G_in = (G_out W^T) masked, with B the slabs of W
//     [K_in, N_out] itself (K-major for a product over N_out), staged by TMA
//     through a ring of BW_STAGES 32 KB stages by one producer thread, on
//     across layers, tiles and the two phases.
//   * Stores off the tensor cores' path: a layer's epilogue only writes each
//     consumer warp's 16 rows to a staging buffer of the warp's own by
//     stmatrix (128-byte swizzle, conflict-free); the warp copies them out
//     while its warpgroup's products of the next layer run, one 64-column
//     chunk after each slab it issues, as 16-byte streaming stores (8 lanes
//     to a 128-byte run of a row). In the forward it also forms the chunk's
//     ReLU mask words from the same 16-byte pieces (mask_bits' test, four
//     lanes OR-ed by shuffles) into its mask buffer, which leaves as 16-byte
//     stores after the layer's last chunk, a row's 32 bytes at a time. No
//     register of an operand in flight is read, and the warp meets no other
//     warp for its stores.
//   * The reverse's mask words prefetched by cp.async into the warp's mask
//     buffer while the layer's products run.
//   * The encoder warps of the producer warpgroup encode the next tile into
//     one buffer of encodings (the staging takes the room of a second), and
//     store the encodings (e, ed) themselves; a group's first tile is
//     encoded during the last group's reverse sweep.
// Activations are written back to shared memory only to leave by the
// staging buffer, which no product waits on (the forward measured ~40%
// slower with its activations written back as A operands, PERF.md).

#pragma once

#include "mlp_fwd_sm90.cuh"
#include "mlp_wgrad.cuh"

namespace {

constexpr int BW_STAGES = 3;  // weight ring depth: four leave no room for the staging buffers
constexpr int REV_SLABS = 26;  // a tile's reverse: R0H (2 slabs), F2, F1, F0H, T3, T2, T1 (4 each)
constexpr int REV_MAPS = 7;
// the reverse's matrices W [K_in, N_out] under a tensor map, in the
// wrapper's order (fused_raymarch.py BWD_MATRICES)
enum { R_T1, R_T2, R_T3, R_F0H, R_F1, R_F2, R_R0H };
constexpr int BW_ENC_BUFS = 1;  // buffers of encodings
constexpr int WARP_ROWS = 16;   // rows of one consumer warp
constexpr int CONSUMER_WARPS = CONSUMER_WGS * WG_THREADS / 32;
constexpr int STG_CHUNK = WARP_ROWS * KC * 2;           // 16 rows x 64 columns: 2 KB
constexpr int STG_BYTES = (WIDTH / KC) * STG_CHUNK;     // a warp's staging buffer: one layer
constexpr int MBUF_BYTES = WARP_ROWS * 8 * 4;           // a warp's 16 rows x 8 mask words
constexpr int LDD_BW = KD + 8;  // the per-ray direction encodings' row (80 bytes)

struct RevMaps {
  CUtensorMap m[REV_MAPS];
};

// The CTA's shared memory from a 1024-byte boundary: the ring, the
// encodings E and D of each consumer warpgroup, each consumer warp's staging
// and mask buffers, the per-sample sigma and rgb, the per-ray direction
// encodings, each tile row's position and ray, then the ring's
// full[BW_STAGES], empty[BW_STAGES] and the encodings' full, empty
// barriers. The compositing backward's two per-sample
// temporaries live in the staging buffers, which no layer uses then.
struct BwdSmem {
  unsigned char* base;
  __device__ __forceinline__ unsigned char* enc(int wg) const {
    return base + BW_STAGES * SLAB_BYTES + wg * 2 * CHUNK_BYTES;
  }
  __device__ __forceinline__ unsigned char* dir(int wg) const { return enc(wg) + CHUNK_BYTES; }
  __device__ __forceinline__ unsigned char* stg(int warp) const {
    return enc(CONSUMER_WGS) + warp * STG_BYTES;
  }
  __device__ __forceinline__ uint32_t* mbuf(int warp) const {
    return reinterpret_cast<uint32_t*>(stg(CONSUMER_WARPS) + warp * MBUF_BYTES);
  }
  __device__ __forceinline__ float* sig() const {
    return reinterpret_cast<float*>(stg(CONSUMER_WARPS) + CONSUMER_WARPS * MBUF_BYTES);
  }
  __device__ __forceinline__ float* rgb() const { return sig() + MAX_RAY_ROWS; }
  __device__ __forceinline__ __nv_bfloat16* dray() const {
    return reinterpret_cast<__nv_bfloat16*>(rgb() + 3 * MAX_RAY_ROWS);
  }
  __device__ __forceinline__ float* xs() const {
    return reinterpret_cast<float*>(dray() + MAX_RAYS * LDD_BW);
  }
  __device__ __forceinline__ int* rayl() const {
    return reinterpret_cast<int*>(xs() + 3 * TILE_ROWS);
  }
  __device__ __forceinline__ uint32_t bars() const { return saddr(rayl() + TILE_ROWS); }
  __device__ __forceinline__ uint32_t enc_bars() const { return bars() + 2 * BW_STAGES * 8; }
};

constexpr size_t BWD_SM90_SMEM =
    (size_t)BW_STAGES * SLAB_BYTES + BW_ENC_BUFS * CONSUMER_WGS * 2 * CHUNK_BYTES +
    CONSUMER_WARPS * (STG_BYTES + MBUF_BYTES) + sizeof(float) * 4 * MAX_RAY_ROWS +
    sizeof(__nv_bfloat16) * MAX_RAYS * LDD_BW + (sizeof(float) * 3 + sizeof(int)) * TILE_ROWS +
    2 * (BW_STAGES + BW_ENC_BUFS) * 8 + 1024;  // + the slack for the alignment
static_assert(BWD_SM90_SMEM <= 232448, "above the shared memory of one block");
static_assert(sizeof(float) * 2 * MAX_RAY_ROWS <= CONSUMER_WARPS * STG_BYTES,
              "the compositing's temporaries fit in the staging buffers");

// the layout, and every barrier initialised; every thread calls it
__device__ __forceinline__ BwdSmem bwd_setup(unsigned char* raw) {
  BwdSmem s{raw + ((1024 - (saddr(raw) & 1023)) & 1023)};
  if (threadIdx.x == 0) {
    for (int st = 0; st < BW_STAGES; ++st) {
      mbar_init(s.bars() + 8 * st, 1);                            // full: the producer's expect-tx
      mbar_init(s.bars() + 8 * (BW_STAGES + st), CONSUMER_WGS);  // empty: one per warpgroup
    }
    mbar_init(s.enc_bars(), ENC_THREADS);       // full: every encoder thread
    mbar_init(s.enc_bars() + 8, CONSUMER_WGS);  // empty: one per warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// EncBufs of mlp_fwd_sm90.cuh with one buffer: the encoders fill it once
// both consumer warpgroups have released it and publish it; the consumers
// wait for it, then release it once their products that read it are done.
struct EncBuf {
  uint32_t bars;  // full, then empty
  uint32_t phase;
  __device__ __forceinline__ void acquire() const { mbar_wait(bars + 8, phase ^ 1); }  // encoders
  __device__ __forceinline__ void publish() {  // encoders
    fence_async_shared();
    mbar_arrive(bars);
    phase ^= 1;
  }
  __device__ __forceinline__ void wait() const {  // consumers
    mbar_wait(bars, phase);
    __syncwarp();
  }
  __device__ __forceinline__ void release() {  // consumers
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive(bars + 8);
    phase ^= 1;
  }
};

// slab s of a tile's reverse: its matrix and first k (every one 256 rows of n)
__device__ __forceinline__ void rev_slab_of(int s, int& map, int& k0) {
  if (s < 2) {
    map = R_R0H;
    k0 = s * KC;
  } else {
    map = R_F2 - (s - 2) / 4;
    k0 = ((s - 2) % 4) * KC;
  }
}

// One thread loads, for each of `groups` ray groups of `tiles` tiles, the
// forward's slabs of every tile, then the reverse's, each into the next
// stage once both warpgroups have released it.
__device__ __forceinline__ void produce_bwd(const WeightMaps& fwd, const RevMaps& rev,
                                            const BwdSmem& sm, int groups, int tiles) {
  const uint32_t ring = saddr(sm.base), bars = sm.bars();
  int stage = 0;
  uint32_t phase = 1;  // the empty barriers' first wait passes
  auto load = [&](const CUtensorMap* map, int k0, int n) {
    mbar_wait(bars + 8 * (BW_STAGES + stage), phase);
    mbar_expect_tx(bars + 8 * stage, n * KC * 2);
    for (int h = 0; h < HALVES; ++h)
      tma_load_2d(ring + stage * SLAB_BYTES + h * (n / HALVES) * KC * 2, map, k0, h * (n / HALVES),
                  bars + 8 * stage);
    if (++stage == BW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int g = 0; g < groups; ++g) {
    for (int it = 0; it < tiles * SLABS; ++it) {
      int map, k0, n;
      slab_of(it % SLABS, map, k0, n);
      load(&fwd.m[map], k0, n);
    }
    for (int it = 0; it < tiles * REV_SLABS; ++it) {
      int map, k0;
      rev_slab_of(it % REV_SLABS, map, k0);
      load(&rev.m[map], k0, WIDTH);
    }
  }
}

// a consumer warpgroup's place in the ring
struct BwRing {
  uint32_t slabs, bars;
  int stage;
  uint32_t phase;
};

// ring_slab of mlp_fwd_sm90.cuh on this ring, with side() run while the
// slab's products are in flight
template <class Issue, class Side>
__device__ __forceinline__ void bw_ring_slab(BwRing& ring, int& held, const Issue& issue,
                                             const Side& side) {
  mbar_wait(ring.bars + 8 * ring.stage, ring.phase);
  __syncwarp();  // the warp converged again for the .aligned wgmma
  wgmma_fence();
  issue(sw128_desc(ring.slabs + ring.stage * SLAB_BYTES));
  wgmma_commit();
  side();
  if (held >= 0) {
    wgmma_wait<1>();
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive(ring.bars + 8 * (BW_STAGES + held));
  }
  held = ring.stage;
  if (++ring.stage == BW_STAGES) {
    ring.stage = 0;
    ring.phase ^= 1;
  }
}

// mma_layer of mlp_fwd_sm90.cuh on this ring: acc[64 rows x N] = X @ (the
// next RS slabs) [+ A @ (one slab more)], X in registers as A fragments, A
// one 64-column chunk in shared memory at a (0: none); side(j) runs while
// slab j's products are in flight
template <int N, int RS, class Side>
__device__ __forceinline__ void bw_mma_layer(float (&acc)[N / 2], BwRing& ring,
                                             uint32_t (&x)[WIDTH / 4], uint32_t a,
                                             const Side& side) {
  int held = -1;
  fence_acc(acc);
  fence_regs(x);
#pragma unroll
  for (int j = 0; j < RS; ++j)
    bw_ring_slab(ring, held, [&](uint64_t db) {
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        const int f = 4 * (4 * j + k);
        if constexpr (N == WIDTH)
          wgmma_n256_rs(acc, x[f], x[f + 1], x[f + 2], x[f + 3], db + 2 * k, (j | k) != 0);
        else
          wgmma_n128_rs(acc, x[f], x[f + 1], x[f + 2], x[f + 3], db + 2 * k, (j | k) != 0);
      }
    }, [&] { side(j); });
  if (a != 0)
    bw_ring_slab(ring, held, [&](uint64_t db) {
      const uint64_t da = sw128_desc(a);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        if constexpr (N == WIDTH)
          wgmma_n256(acc, da + 2 * k, db + 2 * k, (RS | k) != 0);
        else
          wgmma_n128(acc, da + 2 * k, db + 2 * k, (RS | k) != 0);
      }
    }, [] {});
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(x);
  if (threadIdx.x % WG_THREADS == 0) mbar_arrive(ring.bars + 8 * (BW_STAGES + held));
}

// --------------------------------------------------------- keeping rows

// Where one consumer warp keeps its 16 rows: the scratch from its first
// point p0, the rows of the 16 that are stored, the mask words from p0's,
// its staging and mask buffers.
struct WarpKeep {
  Scratch<__nv_bfloat16> sc;
  long long p0;
  int rows;
  uint32_t* masks;
  unsigned char* stg;
  uint32_t* mbuf;
};

// A layer staged and not yet stored: its scratch block from the warp's
// first row, its width, and its mask words' first (-1: none)
struct Pending {
  __nv_bfloat16* dst;
  int ch, w0;
};

__device__ __forceinline__ Pending pending(const WarpKeep& k, int ch0, int ch, int w0) {
  return Pending{k.sc.row(ch0, ch, k.p0), ch, w0};
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Columns [0, CH) of the warp's rows, held as A fragments x (x[2 b + h]:
// rows l / 4 + 8 h, columns 8 b + 2 (l % 4) + {0, 1}), into its staging
// buffer by stmatrix: 64-column chunk c at c * STG_CHUNK, 16-byte piece j of
// its row r at r * 128 + (j ^ (r % 8)) * 16
template <int CH, int NX>
__device__ __forceinline__ void stage_frags(const uint32_t (&x)[NX], const WarpKeep& k) {
  static_assert(4 * NX >= CH, "the fragments hold every column");
  const int lane = threadIdx.x & 31;
  // lane l gives row l % 8 (+ 8 for matrices 1 and 3) of matrix l / 8,
  // matrices 2 and 3 one 8-column block on
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = lane >> 4;
  const uint32_t stg = saddr(k.stg);
  __syncwarp();  // the last layer's chunks have been read
#pragma unroll
  for (int c = 0; c < CH / KC; ++c)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int b = c * 8 + j;
      stmatrix_x4(stg + c * STG_CHUNK + ar * 128 + (((j + ac) ^ (ar & 7)) << 4), x[2 * b],
                  x[2 * b + 1], x[2 * b + 2], x[2 * b + 3]);
    }
  __syncwarp();
}

// Chunk c (64 columns) of the staged layer p to the scratch as 16-byte
// streaming stores, lane l moving piece l % 8 of rows l / 8 + 4 i. With
// p.w0 >= 0 also its mask words p.w0 + 2c, + 1 (mask_bits' test of the same
// pieces, the 4 lanes of a word OR-ed by shuffles) into the warp's mask
// buffer (row r at words 8 r), whose rows leave after the layer's last
// chunk as 16-byte stores.
__device__ __forceinline__ void drain_chunk(const WarpKeep& k, const Pending& p, int c) {
  const int lane = threadIdx.x & 31, j = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + (lane >> 3);
    const uint4 v =
        *reinterpret_cast<const uint4*>(k.stg + c * STG_CHUNK + r * 128 + ((j ^ (r & 7)) << 4));
    if (r < k.rows)
      __stcs(reinterpret_cast<uint4*>(p.dst + (long long)r * p.ch + c * KC + j * 8), v);
    if (p.w0 >= 0) {
      uint32_t bits = positive_bits<__nv_bfloat16>(v) << (8 * (j & 3));
      bits |= __shfl_xor_sync(FULL, bits, 1);
      bits |= __shfl_xor_sync(FULL, bits, 2);
      const uint32_t next = __shfl_xor_sync(FULL, bits, 4);  // the word of pieces 4-7
      if (j == 0) *reinterpret_cast<uint2*>(k.mbuf + r * 8 + 2 * c) = make_uint2(bits, next);
    }
  }
  if (p.w0 >= 0 && c == p.ch / KC - 1) {
    __syncwarp();
    const int r = lane >> 1, half = lane & 1;  // 2 pieces of 4 words a row
    if (r < k.rows && half < p.ch / (2 * KC))
      *reinterpret_cast<uint4*>(k.masks + (long long)r * MASK_WORDS + p.w0 + 4 * half) =
          reinterpret_cast<const uint4*>(k.mbuf + r * 8)[half];
    __syncwarp();
  }
}

// the side work of a layer's slabs: chunk j of p after slab j
struct DrainSide {
  const WarpKeep& k;
  Pending p;
  __device__ __forceinline__ void operator()(int j) const {
    if (j < p.ch / KC) drain_chunk(k, p, j);
  }
};

// every chunk of p at once
__device__ __forceinline__ void drain_all(const WarpKeep& k, const Pending& p) {
  for (int c = 0; c < p.ch / KC; ++c) drain_chunk(k, p, c);
}

// The mask words w0 .. w0 + WORDS of the warp's rows into its mask buffer
// (row r at words 8 r), by cp.async: one 16-byte piece a lane
template <int WORDS>
__device__ __forceinline__ void fetch_masks(const WarpKeep& k, int w0) {
  constexpr int PIECES = WORDS / 4;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane is done with the buffer's last words
  if (k.rows > 0 && lane < WARP_ROWS * PIECES) {
    const int r = lane / PIECES, pc = lane % PIECES;
    const bool in = r < k.rows;
    cp_async16(k.mbuf + r * 8 + 4 * pc, k.masks + (long long)(in ? r : 0) * MASK_WORDS + w0 + 4 * pc,
               in ? 16 : 0);
  }
  cp_async_commit();
}

// the fetched mask words are in (fetch_masks)
__device__ __forceinline__ void masks_in() {
  cp_async_wait<0>();
  __syncwarp();
}

// word w of the fetched mask words of this lane's row m + 8 h, shifted so
// that column 8 b + 2 (l % 4) + e of the word is bit 8 b + e
__device__ __forceinline__ uint32_t lane_mask(const WarpKeep& k, int h, int w) {
  const int lane = threadIdx.x & 31;
  return k.mbuf[((lane >> 2) + 8 * h) * 8 + w] >> (2 * (lane & 3));
}

// ---------------------------------------------------- the two phases

// One consumer warpgroup's 64 rows through the forward, as mlp_rows of
// mlp_fwd_sm90.cuh, keeping through k every layer's input and each ReLU
// layer's mask words (a0..a5 and h while the layer that reads it runs, r0
// after the last); e and ed are the encoders' to keep.
template <class Out>
__device__ __forceinline__ void mlp_rows_keep(const MlpArgs& a, BwRing& ring,
                                              const unsigned char* E, const unsigned char* D,
                                              const Out& out, const WarpKeep& k) {
  const uint32_t e_s = saddr(E), d_s = saddr(D);
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int m = ((threadIdx.x % WG_THREADS) >> 5) * 16 + (lane >> 2);
  float acc[128], acc2[64], s[2];
  uint32_t x[WIDTH / 4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WIDTH / 4; ++i) x[i] = 0u;
  bw_mma_layer<WIDTH, 0>(acc, ring, x, e_s, [](int) {});
  to_operand<true, false>(acc, a.b[T0B], x, nullptr, s);
  stage_frags<WIDTH>(x, k);
  Pending p = pending(k, C_A0, WIDTH, 0);
#pragma unroll 1
  for (int l = 0; l < 3; ++l) {  // T1, T2, T3
    bw_mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0, DrainSide{k, p});
    to_operand<true, false>(acc, a.b[T1B + l], x, nullptr, s);
    stage_frags<WIDTH>(x, k);
    p = pending(k, C_A1 + l * WIDTH, WIDTH, 8 * (l + 1));
  }
  // skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
  bw_mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, e_s, DrainSide{k, p});
  to_operand<true, false>(acc, a.b[F0B], x, nullptr, s);
  stage_frags<WIDTH>(x, k);
  p = pending(k, C_A4, WIDTH, 32);
  bw_mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0, DrainSide{k, p});
  to_operand<true, false>(acc, a.b[F1B], x, nullptr, s);
  stage_frags<WIDTH>(x, k);
  p = pending(k, C_A5, WIDTH, 40);
  // h: no activation; sigma from its bf16 values
  bw_mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0, DrainSide{k, p});
  to_operand<false, true>(acc, a.b[F2B], x, static_cast<const __nv_bfloat16*>(a.w[DW]), s);
  const float db = __ldg(a.b[DB]);
  s[0] = quad_sum(s[0]);
  s[1] = quad_sum(s[1]);
  if (q == 0) {
    out.sigma(m, fmaxf(s[0] + db, 0.f));
    out.sigma(m + 8, fmaxf(s[1] + db, 0.f));
  }
  stage_frags<WIDTH>(x, k);
  p = pending(k, C_H, WIDTH, -1);
  // rgb hidden: concat(h, ed) @ W == h @ W_h + ed @ W_d, then the rgb head
  // from its bf16-rounded values
#pragma unroll
  for (int i = 0; i < 64; ++i) acc2[i] = 0.f;
  bw_mma_layer<RGB_WIDTH, WIDTH / KC>(acc2, ring, x, d_s, DrainSide{k, p});
  const float* bias = a.b[R0B];
  const __nv_bfloat16* r1w = static_cast<const __nv_bfloat16*>(a.w[R1]);  // [3, RGB_WIDTH]
  uint32_t r0[RGB_WIDTH / 4];
  float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < RGB_WIDTH / 8; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias) + 4 * i + q);
    const uint32_t lo = pack_bf16x2<true>(acc2[4 * i] + b.x, acc2[4 * i + 1] + b.y);
    const uint32_t hi = pack_bf16x2<true>(acc2[4 * i + 2] + b.x, acc2[4 * i + 3] + b.y);
    r0[2 * i] = lo;
    r0[2 * i + 1] = hi;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      const unsigned wbits =
          __ldg(reinterpret_cast<const unsigned*>(r1w + kk * RGB_WIDTH) + 4 * i + q);
      const float w0 = bf16_lo(wbits), w1 = bf16_hi(wbits);
      c[0][kk] = fmaf(bf16_hi(lo), w1, fmaf(bf16_lo(lo), w0, c[0][kk]));
      c[1][kk] = fmaf(bf16_hi(hi), w1, fmaf(bf16_lo(hi), w0, c[1][kk]));
    }
  }
  const float* rb = a.b[R1B];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[3];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
      v[kk] = 1.f / (1.f + expf(-(quad_sum(c[h][kk]) + __ldg(rb + kk))));
    if (q == 0) out.rgb(m + 8 * h, v[0], v[1], v[2]);
  }
  stage_frags<RGB_WIDTH>(r0, k);
  drain_all(k, pending(k, C_R0, RGB_WIDTH, MW_R0));
}

// One consumer warpgroup's 64 rows (wg_rows of them stored, from point p0)
// through the reverse sweep of reverse_sweep<bf16>, from g_sigpre gsig[64]
// and g_rgbpre grgb[64][3] (already rounded to bf16): the heads' block,
// g_r0 = (g_rgbpre @ r1w^T) where r0 > 0, g_h = g_r0 @ R0H^T + g_sigpre *
// dw, then g_a5 .. g_a0, each product's masked output rounded to bf16 as the
// next one's A operand and kept through k.
__device__ __forceinline__ void reverse_rows(const MlpArgs& a, BwRing& ring,
                                             const Scratch<__nv_bfloat16>& sc, long long p0,
                                             int wg_rows, const float* gsig, const float* grgb,
                                             const WarpKeep& k) {
  const int tid = threadIdx.x % WG_THREADS, lane = threadIdx.x & 31, q = lane & 3;
  const int m = (tid >> 5) * 16 + (lane >> 2);
  // the heads' block: one 16-byte piece per row
  if (tid < wg_rows) {
    __align__(16) __nv_bfloat16 head[8];
    head[0] = fromf<__nv_bfloat16>(gsig[tid]);
#pragma unroll
    for (int c = 0; c < 3; ++c) head[c + 1] = fromf<__nv_bfloat16>(grgb[tid * 3 + c]);
#pragma unroll
    for (int c = 4; c < 8; ++c) head[c] = fromf<__nv_bfloat16>(0.f);
    __stcs(reinterpret_cast<uint4*>(sc.row(C_HEAD, 8, p0 + tid)),
           *reinterpret_cast<const uint4*>(head));
  }
  fetch_masks<4>(k, MW_R0);
  float acc[128];
  uint32_t x[WIDTH / 4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WIDTH / 4; ++i) x[i] = 0u;
  {
    // g_r0 into x[0 .. RGB_WIDTH / 4), the A fragments of K = 128
    masks_in();
    float g[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) g[h][c] = grgb[(m + 8 * h) * 3 + c];
    const unsigned* r1w = static_cast<const unsigned*>(a.w[R1]);  // [3, RGB_WIDTH] bf16 pairs
#pragma unroll
    for (int b = 0; b < RGB_WIDTH / 8; ++b) {
      unsigned wb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) wb[c] = __ldg(r1w + c * (RGB_WIDTH / 2) + 4 * b + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = lane_mask(k, h, b >> 2) >> (8 * (b & 3));
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w0 = e ? bf16_hi(wb[0]) : bf16_lo(wb[0]);
          const float w1 = e ? bf16_hi(wb[1]) : bf16_lo(wb[1]);
          const float w2 = e ? bf16_hi(wb[2]) : bf16_lo(wb[2]);
          const float t = __fadd_rn(__fadd_rn(__fmul_rn(g[h][0], w0), __fmul_rn(g[h][1], w1)),
                                    __fmul_rn(g[h][2], w2));
          v[e] = (word >> e) & 1u ? t : 0.f;
        }
        x[2 * b + h] = pack_bf16x2<false>(v[0], v[1]);
      }
    }
  }
  stage_frags<RGB_WIDTH>(x, k);
  Pending p = pending(k, C_GR0, RGB_WIDTH, -1);
  fetch_masks<8>(k, 40);
  // g_h = g_r0 @ R0H^T + g_sigpre * dw (no activation)
  bw_mma_layer<WIDTH, RGB_WIDTH / KC>(acc, ring, x, 0, DrainSide{k, p});
  {
    const float g0 = gsig[m], g1 = gsig[m + 8];
    const unsigned* dw = static_cast<const unsigned*>(a.w[DW]);
#pragma unroll
    for (int b = 0; b < WIDTH / 8; ++b) {
      const unsigned wbits = __ldg(dw + 4 * b + q);
      const float w0 = bf16_lo(wbits), w1 = bf16_hi(wbits);
      x[2 * b] = pack_bf16x2<false>(__fadd_rn(acc[4 * b], __fmul_rn(g0, w0)),
                                    __fadd_rn(acc[4 * b + 1], __fmul_rn(g0, w1)));
      x[2 * b + 1] = pack_bf16x2<false>(__fadd_rn(acc[4 * b + 2], __fmul_rn(g1, w0)),
                                        __fadd_rn(acc[4 * b + 3], __fmul_rn(g1, w1)));
    }
  }
  stage_frags<WIDTH>(x, k);
  p = pending(k, C_GH, WIDTH, -1);
  // g_a5 .. g_a0: the products with F2, F1, F0H, T3, T2, T1 (transposed),
  // masked by a5 .. a0
#pragma unroll 1
  for (int l = 0; l < 6; ++l) {
    bw_mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0, DrainSide{k, p});
    masks_in();
#pragma unroll
    for (int b = 0; b < WIDTH / 8; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = lane_mask(k, h, b >> 2) >> (8 * (b & 3));
        x[2 * b + h] = pack_bf16x2<false>(word & 1u ? acc[4 * b + 2 * h] : 0.f,
                                          word & 2u ? acc[4 * b + 2 * h + 1] : 0.f);
      }
    stage_frags<WIDTH>(x, k);
    p = pending(k, C_GA5 - l * WIDTH, WIDTH, -1);
    if (l < 5) fetch_masks<8>(k, 32 - 8 * l);
  }
  drain_all(k, p);
}

}  // namespace

// The 7 tensor maps of the reverse sweep: ws[i] is matrix i (R_T1 .. R_R0H)
// as W [K_in, N_out] bf16 on the card, K_in = 256, N_out = 256 (128 for
// R0H), its box 64 x 128; maps receives REV_MAPS * 128 bytes. Returns 0,
// the failing CUresult, or -4 when the driver's encoder cannot be reached.
extern "C" int fused_raymarch_bwd_maps(const void* const* ws, void* maps) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return -4;
  const Encode encode = reinterpret_cast<Encode>(fn);
  for (int i = 0; i < REV_MAPS; ++i) {
    const cuuint64_t n = i == R_R0H ? RGB_WIDTH : WIDTH;
    const cuuint64_t dims[2] = {n, WIDTH}, strides[1] = {n * 2};
    const cuuint32_t box[2] = {KC, WIDTH / HALVES}, steps[2] = {1, 1};
    CUtensorMap map;
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ws[i]),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)r;
    memcpy(static_cast<char*>(maps) + i * sizeof(CUtensorMap), &map, sizeof(CUtensorMap));
  }
  return 0;
}
