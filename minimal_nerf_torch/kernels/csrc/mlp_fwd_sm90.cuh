// The bf16 forward MLP on Hopper (sm_90a), shared by the fused ray-march
// forward (fused_raymarch_fwd.cu) and the point forward
// (raymarch_mlp_fwd.cu): weights staged by TMA, products on wgmma, a
// producer warpgroup (one loading thread, three encoding warps) and two
// consumer warpgroups.
//
// It computes what mlp_forward<bf16> followed by heads<bf16> computes
// (`_fused_forward_core` of minimal_nerf_tpu/kernels/fused_raymarch.py and
// `_nerf_mlp_kernel` of minimal_nerf_tpu/kernels/raymarch.py), with the same
// rounding points: the encodings and every activation, h included, are
// stored in bf16; products accumulate in fp32 and biases are added in fp32;
// sigma and rgb are fp32 and read the bf16 values of h and r0 that are
// stored; the skip and rgb concatenations are split products.
//
// What bounds it: tensor-core operations, 460,416 multiply-adds per row.
// What the design does about that:
//   * Products on wgmma (m64n256k16, m64n128k16 for the rgb layer) with
//     fp32 sums in registers. Two consumer warpgroups own 64 rows each of a
//     CTA's 128-row tile through every layer. Rows are independent, so the
//     warpgroups meet at no barrier between layers.
//   * A layer's output never leaves the registers: its epilogue (bias, ReLU,
//     rounding to bf16) packs the accumulators of its rows straight into the
//     next layer's A fragments (wgmma with A from registers), so no
//     activation is stored, fenced or synchronised in shared memory. Only
//     the encodings E and D (read by T0, F0E and R0D) are A tiles in shared
//     memory, in the 128-byte swizzled K-major layout the descriptors read:
//     16-byte piece j of row r of a 64-column chunk sits at piece j ^ (r % 8).
//   * Weights staged by TMA. The wrapper keeps each matrix as W^T [N, Kp]
//     bf16 (K-major) under one CUtensorMap (128-byte swizzle, a 64 x N / 2
//     box). One producer thread walks the 31 slabs of a tile (T0 | T1-T3 |
//     F0H, F0E | F1 | F2 | R0H, R0D) through a ring of STAGES 32 KB stages,
//     on across layer and tile boundaries, with an mbarrier per stage for
//     its bytes (expect-tx) and one for its release by both warpgroups.
//   * The encodings off the consumers' path: the producer warpgroup's other
//     three warps encode the next tile into the other of two E/D buffers
//     (ENC_BUFS), handed over through mbarriers, while the consumers
//     multiply the current one. setmaxnreg gives that warpgroup 56
//     registers, the consumers 224.
//   * The heads in the epilogues: sigma = relu(h . dw + db) from F2's
//     bf16-rounded outputs, rgb = sigmoid(r0 @ r1w + r1b) from R0's, each
//     reduced over the 4 lanes that hold a row's columns.
//   * A persistent grid, one CTA per SM, so the ring runs on across tiles.
// Measured and set aside (PERF.md, kernels/variants.py): activations
// written back to shared memory between layers (even by stmatrix: the
// stores cost ~40%), each slab multicast to a 2-CTA cluster (CLUSTER 2:
// slower, the weights' L2 traffic is not the limit), the bias loaded into
// the accumulators before the products (ptxas then spills).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call goes through the runtime
#include <string.h>

#include "fused_raymarch_common.cuh"

namespace {

constexpr int WG_THREADS = 128;
constexpr int CONSUMER_WGS = 2;
constexpr int SM90_THREADS = WG_THREADS * (CONSUMER_WGS + 1);
constexpr int WG_ROWS = 64;                          // rows of one consumer warpgroup
constexpr int KC = 64;                               // k of one slab: one 128-byte row
constexpr int STAGES = 4;                            // weight ring depth
constexpr int ENC_BUFS = 2;                          // E and D buffers of the encoder warps
constexpr int ENC_THREADS = WG_THREADS - 32;         // the producer warpgroup's warps 1-3
constexpr int TILE_ROWS = CONSUMER_WGS * WG_ROWS;    // a CTA's rows per pass of the weights
// setmaxnreg: the CTA keeps the registers it was launched with (168 a
// thread at 384 threads), so 128 * PRODUCER_REGS + 256 * CONSUMER_REGS may
// not exceed 384 * 168
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(WG_THREADS * PRODUCER_REGS + CONSUMER_WGS * WG_THREADS * CONSUMER_REGS <=
                  SM90_THREADS * 168,
              "setmaxnreg asks for more registers than the CTA holds");
constexpr int CLUSTER = 1;                           // CTAs sharing each slab (TMA multicast)
constexpr int SLAB_BYTES = WIDTH * KC * 2;           // 32 KB
constexpr int CHUNK_BYTES = WG_ROWS * KC * 2;        // 64 rows x 64 columns: 8 KB
constexpr int SLABS = 31;                            // weight slabs per tile
constexpr int NUM_MAPS = 10;
// the matrices under a tensor map, in the wrapper's order
enum { M_T0, M_T1, M_T2, M_T3, M_F0H, M_F0E, M_F1, M_F2, M_R0H, M_R0D };
// the ring, E and D per buffer and consumer warpgroup, then the ring's
// full[STAGES], empty[STAGES] and the buffers' full[ENC_BUFS],
// empty[ENC_BUFS] barriers
constexpr int MLP_SMEM = STAGES * SLAB_BYTES + ENC_BUFS * CONSUMER_WGS * 2 * CHUNK_BYTES +
                         2 * (STAGES + ENC_BUFS) * 8;
// a slab arrives as two halves of N / 2 rows (a tensor map's box): with a
// cluster of two, each CTA loads one half into both
constexpr int HALVES = 2;
static_assert(CLUSTER == 1 || CLUSTER == HALVES, "a cluster shares a slab's two halves");
// named barriers: 0 is __syncthreads, 1 all consumers, 2 the encoders, 3 +
// wg one consumer warpgroup
constexpr int BAR_CONSUMERS = 1, BAR_ENCODERS = 2, BAR_WG0 = 3;
// Clock counts of the consumer warpgroups' phases, summed over warpgroups
// into phase_cycles (read and reset by mlp_fwd_sm90_phase_cycles): waits on
// a slab's bytes, issuing the products, waits on them (wgmma.wait_group),
// the epilogues and heads; each call of mlp_rows whole; and the time
// between two calls (encodings, compositing). Off as built
// (kernels/variants.py turns it on).
constexpr bool TIMING = false;
enum { PH_FULL, PH_ISSUE, PH_MMA, PH_EPI, PH_ROWS, PH_OUTSIDE, PH_COUNT };
__device__ unsigned long long phase_cycles[PH_COUNT];

struct WeightMaps {
  CUtensorMap m[NUM_MAPS];
};

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` of bar completes. A wait of ~10 s
// (2^34 cycles) can only be a fault in the pipeline: trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// the box at (c0 innermost, c1) of map into shared memory at dst; its bytes
// complete on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same box into shared memory at dst of every CTA of the cluster in
// mask, each CTA's bar at the same offset
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                      int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// one arrival on bar of every CTA of the cluster (this CTA's alone without
// one)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  if constexpr (CLUSTER == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (uint32_t c = 0; c < CLUSTER; ++c)
      asm volatile(
          "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
          "r"(c)
          : "memory");
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic stores to shared memory made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a K-major operand in the 128-byte swizzled layout from addr (its 8-row
// groups 1024 bytes apart); + 2 per 16 columns of k
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// orders the compiler's own reads and writes of the accumulators around
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F64(i) WG_F16(i), WG_F16(i + 16), WG_F16(i + 32), WG_F16(i + 48)

// d[64 rows x 256] (+)= A[64 x 16] @ B[16 x 256], both K-major in shared
// memory; acc == 0 overwrites d
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(0), WG_F64(64)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 rows x 128] (+)= A[64 x 16] @ B[16 x 128]
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(0)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 256] (+)= A[64 x 16] @ B[16 x 256], A from registers: this
// thread's bf16x2 fragment a0..a3 (rows m and m + 8, columns 2 (l % 4) and
// 8 + 2 (l % 4) of the 16)
__device__ __forceinline__ void wgmma_n256_rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : WG_F64(0), WG_F64(64)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

// d[64 x 128] (+)= A[64 x 16] @ B[16 x 128], A from registers
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_F64(0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

#undef WG_F64
#undef WG_F16
#undef WG_F4

// ------------------------------------------------------- shared memory

// The CTA's shared memory from a 1024-byte boundary (the swizzle's period):
// the ring, the encodings E and D of each buffer and consumer warpgroup,
// the barriers, then the kernel's own buffers (extra).
struct Sm90Smem {
  unsigned char* base;
  __device__ __forceinline__ unsigned char* enc(int buf, int wg) const {
    return base + STAGES * SLAB_BYTES + (buf * CONSUMER_WGS + wg) * 2 * CHUNK_BYTES;
  }
  __device__ __forceinline__ unsigned char* dir(int buf, int wg) const {
    return enc(buf, wg) + CHUNK_BYTES;
  }
  __device__ __forceinline__ uint32_t bars() const { return saddr(enc(ENC_BUFS, 0)); }
  __device__ __forceinline__ uint32_t enc_bars() const { return bars() + 2 * STAGES * 8; }
  __device__ __forceinline__ unsigned char* extra() const { return base + MLP_SMEM; }
};

// the dynamic shared memory a kernel asks for: the MLP's, its own, and the
// slack for the alignment
constexpr size_t sm90_smem_bytes(size_t extra) { return MLP_SMEM + extra + 1024; }

// the layout, and the ring's barriers initialised; every thread calls it
__device__ __forceinline__ Sm90Smem sm90_setup(unsigned char* raw) {
  Sm90Smem s{raw + ((1024 - (saddr(raw) & 1023)) & 1023)};
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(s.bars() + 8 * st, 1);                        // full: the producer's expect-tx
      // empty: one per warpgroup of every CTA that shares the slab
      mbar_init(s.bars() + 8 * (STAGES + st), CONSUMER_WGS * CLUSTER);
    }
    for (int b = 0; b < ENC_BUFS; ++b) {
      mbar_init(s.enc_bars() + 8 * b, ENC_THREADS);                // full: every encoder thread
      mbar_init(s.enc_bars() + 8 * (ENC_BUFS + b), CONSUMER_WGS);  // empty: one per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CLUSTER > 1) cluster_sync();  // the peers' barriers exist before any arrival
  return s;
}

// slab s of a tile: its matrix, first k, and width N
__device__ __forceinline__ void slab_of(int s, int& map, int& k0, int& n) {
  n = WIDTH;
  k0 = 0;
  if (s == 0) {
    map = M_T0;
  } else if (s < 13) {  // T1, T2, T3
    map = M_T1 + (s - 1) / 4;
    k0 = ((s - 1) % 4) * KC;
  } else if (s < 17) {
    map = M_F0H;
    k0 = (s - 13) * KC;
  } else if (s == 17) {
    map = M_F0E;
  } else if (s < 26) {  // F1, F2
    map = M_F1 + (s - 18) / 4;
    k0 = ((s - 18) % 4) * KC;
  } else if (s < 30) {
    map = M_R0H;
    k0 = (s - 26) * KC;
    n = RGB_WIDTH;
  } else {
    map = M_R0D;
    n = RGB_WIDTH;
  }
}

// The producer warpgroup's registers given up to the consumers; its warp 0
// loads the weights (produce), warps 1-3 encode (ENC_THREADS).
__device__ __forceinline__ void producer_setup() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
}

// One thread loads the slabs of `tiles` tiles in order, each into the next
// stage once both warpgroups (of each CTA of the cluster) have released it:
// both halves, or with a cluster this CTA's half into every CTA. With a
// cluster it then waits for the last releases, so no peer arrives on this
// CTA's barriers after it exits.
__device__ __forceinline__ void produce(const WeightMaps& maps, const Sm90Smem& sm, int tiles) {
  const uint32_t ring = saddr(sm.base), bars = sm.bars();
  const int half0 = CLUSTER > 1 ? (int)cluster_rank() : 0;
  int stage = 0;
  uint32_t phase = 1;  // the empty barriers' first wait passes
  for (int it = 0; it < tiles * SLABS; ++it) {
    int map, k0, n;
    slab_of(it % SLABS, map, k0, n);
    mbar_wait(bars + 8 * (STAGES + stage), phase);
    mbar_expect_tx(bars + 8 * stage, n * KC * 2);
    for (int h = half0; h < half0 + HALVES / CLUSTER; ++h) {
      const uint32_t dst = ring + stage * SLAB_BYTES + h * (n / HALVES) * KC * 2;
      if constexpr (CLUSTER > 1)
        tma_load_2d_multicast(dst, &maps.m[map], k0, h * (n / HALVES), bars + 8 * stage,
                              (uint16_t)((1u << CLUSTER) - 1));
      else
        tma_load_2d(dst, &maps.m[map], k0, h * (n / HALVES), bars + 8 * stage);
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if constexpr (CLUSTER > 1) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_wait(bars + 8 * (STAGES + stage), phase);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// the items (tiles or ray groups) a persistent CTA walks, from blockIdx.x
// in steps of gridDim.x: with a cluster every CTA walks as many (those past
// `items` mask every row), since its peers load its weights
__device__ __forceinline__ int persistent_iters(long long items) {
  const long long first = CLUSTER > 1 ? 0 : blockIdx.x;
  return (int)((items - first + gridDim.x - 1) / gridDim.x);
}

// a consumer warpgroup's place in the ring
struct Ring {
  uint32_t slabs, bars;
  int stage;
  uint32_t phase;
  // TIMING: this thread's clocks by phase, the end of its last product
  // wait and of its last mlp_rows
  long long clk[PH_ROWS], mark, last;
};

__device__ __forceinline__ long long tick() { return TIMING ? clock64() : 0; }

// TIMING: ring.clk[ph] += the clocks since t, and t = now
__device__ __forceinline__ void lap(Ring& ring, int ph, long long& t) {
  if constexpr (TIMING) {
    const long long now = clock64();
    ring.clk[ph] += now - t;
    t = now;
  }
}

__device__ __forceinline__ void consumer_setup() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
}

// A side's place in the encoders' buffers: the encoders fill buffer `buf`
// once both consumer warpgroups have released it and publish it through
// its full barrier (each encoder thread's stores fenced for wgmma first);
// the consumers wait for it, then release it once their products that read
// it are done.
struct EncBufs {
  uint32_t bars;  // full[ENC_BUFS], then empty[ENC_BUFS]
  int buf;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++buf == ENC_BUFS) {
      buf = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ void acquire() {  // encoders
    mbar_wait(bars + 8 * (ENC_BUFS + buf), phase ^ 1);
  }
  __device__ __forceinline__ void publish() {  // encoders
    fence_async_shared();
    mbar_arrive(bars + 8 * buf);
    next();
  }
  __device__ __forceinline__ void wait() const {  // consumers
    mbar_wait(bars + 8 * buf, phase);
    __syncwarp();
  }
  __device__ __forceinline__ void release() {  // consumers
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive(bars + 8 * (ENC_BUFS + buf));
    next();
  }
};

// The products of the next slab of the ring: issue(db) issues them against
// the slab's descriptor; the slab held before (held >= 0) is released once
// they are done, then this one is held.
template <class Issue>
__device__ __forceinline__ void ring_slab(Ring& ring, int& held, const Issue& issue) {
  long long t = tick();
  mbar_wait(ring.bars + 8 * ring.stage, ring.phase);
  lap(ring, PH_FULL, t);
  __syncwarp();  // the warp converged again for the .aligned wgmma
  wgmma_fence();
  issue(sw128_desc(ring.slabs + ring.stage * SLAB_BYTES));
  wgmma_commit();
  lap(ring, PH_ISSUE, t);
  if (held >= 0) {
    wgmma_wait<1>();
    lap(ring, PH_MMA, t);
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive_cluster(ring.bars + 8 * (STAGES + held));
  }
  held = ring.stage;
  if (++ring.stage == STAGES) {
    ring.stage = 0;
    ring.phase ^= 1;
  }
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// acc[64 rows x N] = X @ (the next RS slabs) [+ A @ (one slab more)]: X is
// the layer input held as wgmma A fragments in registers (x[4 kk + 0..3]:
// columns 16 kk .. 16 kk + 15), A one 64-column chunk in shared memory
// (sw128) at a (0: none). x stays untouched until the products are done.
template <int N, int RS>
__device__ __forceinline__ void mma_layer(float (&acc)[N / 2], Ring& ring,
                                          uint32_t (&x)[WIDTH / 4], uint32_t a) {
  int held = -1;
  fence_acc(acc);
  fence_regs(x);
#pragma unroll
  for (int j = 0; j < RS; ++j)
    ring_slab(ring, held, [&](uint64_t db) {
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        const int f = 4 * (4 * j + k);
        if constexpr (N == WIDTH)
          wgmma_n256_rs(acc, x[f], x[f + 1], x[f + 2], x[f + 3], db + 2 * k, (j | k) != 0);
        else
          wgmma_n128_rs(acc, x[f], x[f + 1], x[f + 2], x[f + 3], db + 2 * k, (j | k) != 0);
      }
    });
  if (a != 0)
    ring_slab(ring, held, [&](uint64_t db) {
      const uint64_t da = sw128_desc(a);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        if constexpr (N == WIDTH)
          wgmma_n256(acc, da + 2 * k, db + 2 * k, (RS | k) != 0);
        else
          wgmma_n128(acc, da + 2 * k, db + 2 * k, (RS | k) != 0);
      }
    });
  long long t = tick();
  wgmma_wait<0>();
  lap(ring, PH_MMA, t);
  ring.mark = t;  // the epilogue starts
  fence_acc(acc);
  fence_regs(x);
  if (threadIdx.x % WG_THREADS == 0) mbar_arrive_cluster(ring.bars + 8 * (STAGES + held));
}

// ------------------------------------------------------------- epilogues

// Thread (warp w, lane l) of a warpgroup holds rows m = 16 w + l / 4 and
// m + 8 of its 64, columns 8 i + 2 (l % 4) + {0, 1} of each 8-column
// block i: acc[4 i + {0, 1}] in row m, acc[4 i + {2, 3}] in row m + 8.

// two fp32 values as bf16x2, the first in the low half (ReLU first with
// RELU: the same bits as rounding after fmaxf)
template <bool RELU>
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  if constexpr (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// A layer's bias, then ReLU or nothing, rounded to bf16 as the next
// layer's A fragments: x[j] = acc[2 j], acc[2 j + 1] (row m for even j,
// m + 8 for odd, columns 8 (j / 2) + 2 (l % 4) + {0, 1}), which is the wgmma
// A fragment layout of columns 16 kk .. for j = 4 kk + 0..3. With SIGMA
// also returns each of the two rows' partial h . dw over this thread's
// columns.
template <bool RELU, bool SIGMA>
__device__ __forceinline__ void to_operand(const float (&acc)[128], const float* bias,
                                           uint32_t (&x)[WIDTH / 4], const __nv_bfloat16* dw,
                                           float (&s)[2]) {
  const int q = threadIdx.x & 3;
  s[0] = s[1] = 0.f;
#pragma unroll
  for (int blk = 0; blk < WIDTH / 8; ++blk) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias) + 4 * blk + q);
    x[2 * blk] = pack_bf16x2<RELU>(acc[4 * blk] + b.x, acc[4 * blk + 1] + b.y);  // row m
    x[2 * blk + 1] = pack_bf16x2<RELU>(acc[4 * blk + 2] + b.x, acc[4 * blk + 3] + b.y);
    if constexpr (SIGMA) {
      const unsigned wbits = __ldg(reinterpret_cast<const unsigned*>(dw) + 4 * blk + q);
      const float w0 = bf16_lo(wbits), w1 = bf16_hi(wbits);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[h] = fmaf(bf16_hi(x[2 * blk + h]), w1, fmaf(bf16_lo(x[2 * blk + h]), w0, s[h]));
    }
  }
}

// the sum over the 4 lanes that hold a row's columns
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// One consumer warpgroup's 64 rows through the MLP, from their encodings
// E and D (sw128) to the heads: out.sigma(r, v) and out.rgb(r, c0, c1, c2)
// for row r of the 64, from one lane of each row's four. Each layer's
// output stays in registers as the next layer's A operand; only E and D
// are read from shared memory.
template <class Out>
__device__ __forceinline__ void mlp_rows(const MlpArgs& a, Ring& ring, const unsigned char* E,
                                         const unsigned char* D, const Out& out) {
  const long long start = tick();
  const long long outside = TIMING && ring.last != 0 ? start - ring.last : 0;
  auto epilogue_done = [&] {
    long long t = ring.mark;
    lap(ring, PH_EPI, t);
  };
  const uint32_t e_s = saddr(E), d_s = saddr(D);
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int m = ((threadIdx.x % WG_THREADS) >> 5) * 16 + (lane >> 2);
  // The first product of each layer overwrites acc and acc2 (scale-d 0),
  // but the asm reads them: each is zeroed right before its first layer,
  // so its live range (and x's) starts there, not at the kernel's entry.
  float acc[128], acc2[64], s[2];
  uint32_t x[WIDTH / 4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WIDTH / 4; ++i) x[i] = 0u;
  mma_layer<WIDTH, 0>(acc, ring, x, e_s);
  to_operand<true, false>(acc, a.b[T0B], x, nullptr, s);
  epilogue_done();
#pragma unroll 1
  for (int l = 0; l < 3; ++l) {  // T1, T2, T3
    mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0);
    to_operand<true, false>(acc, a.b[T1B + l], x, nullptr, s);
    epilogue_done();
  }
  // skip: concat(a3, e) @ W == a3 @ W_h + e @ W_e
  mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, e_s);
  to_operand<true, false>(acc, a.b[F0B], x, nullptr, s);
  epilogue_done();
  mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0);
  to_operand<true, false>(acc, a.b[F1B], x, nullptr, s);
  epilogue_done();
  // h: no activation; sigma from its bf16 values
  mma_layer<WIDTH, WIDTH / KC>(acc, ring, x, 0);
  to_operand<false, true>(acc, a.b[F2B], x, static_cast<const __nv_bfloat16*>(a.w[DW]), s);
  const float db = __ldg(a.b[DB]);
  s[0] = quad_sum(s[0]);
  s[1] = quad_sum(s[1]);
  if (q == 0) {
    out.sigma(m, fmaxf(s[0] + db, 0.f));
    out.sigma(m + 8, fmaxf(s[1] + db, 0.f));
  }
  epilogue_done();
  // rgb hidden: concat(h, ed) @ W == h @ W_h + ed @ W_d, then the rgb head
  // from its bf16-rounded values
#pragma unroll
  for (int i = 0; i < 64; ++i) acc2[i] = 0.f;
  mma_layer<RGB_WIDTH, WIDTH / KC>(acc2, ring, x, d_s);
  const float* bias = a.b[R0B];
  const __nv_bfloat16* r1w = static_cast<const __nv_bfloat16*>(a.w[R1]);  // [3, RGB_WIDTH]
  float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < RGB_WIDTH / 8; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias) + 4 * i + q);
    const uint32_t lo = pack_bf16x2<true>(acc2[4 * i] + b.x, acc2[4 * i + 1] + b.y);
    const uint32_t hi = pack_bf16x2<true>(acc2[4 * i + 2] + b.x, acc2[4 * i + 3] + b.y);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned wbits =
          __ldg(reinterpret_cast<const unsigned*>(r1w + k * RGB_WIDTH) + 4 * i + q);
      const float w0 = bf16_lo(wbits), w1 = bf16_hi(wbits);
      c[0][k] = fmaf(bf16_hi(lo), w1, fmaf(bf16_lo(lo), w0, c[0][k]));
      c[1][k] = fmaf(bf16_hi(hi), w1, fmaf(bf16_lo(hi), w0, c[1][k]));
    }
  }
  const float* rb = a.b[R1B];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = 1.f / (1.f + expf(-(quad_sum(c[h][k]) + __ldg(rb + k))));
    if (q == 0) out.rgb(m + 8 * h, v[0], v[1], v[2]);
  }
  if constexpr (TIMING) {
    long long end = ring.mark;
    lap(ring, PH_EPI, end);
    if (threadIdx.x % WG_THREADS == 0) {
      for (int k = 0; k < PH_ROWS; ++k)
        atomicAdd(&phase_cycles[k], (unsigned long long)ring.clk[k]);
      atomicAdd(&phase_cycles[PH_ROWS], (unsigned long long)(end - start));
      atomicAdd(&phase_cycles[PH_OUTSIDE], (unsigned long long)outside);
    }
    for (int k = 0; k < PH_ROWS; ++k) ring.clk[k] = 0;
    ring.last = end;
  }
}

// ------------------------------------------------------------- encoders

// encode_pair's channels into row r of a 64-channel sw128 chunk
__device__ __forceinline__ void encode_pair_sw(unsigned char* chunk, int r, int p, int pairs,
                                               int channels, float coord) {
  __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(chunk + r * 128);
  auto at = [&](int c) -> __nv_bfloat16& { return row[(((c >> 3) ^ (r & 7)) << 3) | (c & 7)]; };
  if (p < pairs) {
    const int f = p / 3, c = 6 * f + p % 3;
    const float ang = __fmul_rn(tof(fromf<__nv_bfloat16>(coord)), ldexpf(PI_F, f));
    float sn, cs;
    sincosf(ang, &sn, &cs);
    at(c) = fromf<__nv_bfloat16>(cs);
    at(c + 3) = fromf<__nv_bfloat16>(sn);
  } else {
    const int c = channels + 2 * (p - pairs);
    at(c) = fromf<__nv_bfloat16>(0.f);
    at(c + 1) = fromf<__nv_bfloat16>(0.f);
  }
}

// Launches a persistent kernel over `items`: one CTA per SM (a cluster's
// worth of CTAs per co-resident cluster), never more CTAs than items
// (rounded up to whole clusters). Returns 0 or the cudaError_t.
template <class Params>
int launch_persistent(void (*kernel)(const Params), const Params& prm, long long items,
                      size_t bytes, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, ctas = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&ctas, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(SM90_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (CLUSTER > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(CLUSTER);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = clusters * CLUSTER;
  }
  const long long need = (items + CLUSTER - 1) / CLUSTER * CLUSTER;
  cfg.gridDim = dim3((unsigned)(need < ctas ? need : ctas));
  err = cudaLaunchKernelEx(&cfg, kernel, prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// phase_cycles (TIMING) into out[PH_COUNT], then zero; returns the
// cudaError_t
extern "C" int mlp_fwd_sm90_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[PH_COUNT] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}

// The 10 tensor maps of one MLP: wts[i] is matrix i (M_T0 .. M_R0D) as W^T
// [N, Kp] bf16 on the card, N = 256 (128 for R0H, R0D), Kp = 64 for T0,
// F0E and R0D and 256 otherwise, its box 64 x N / 2; maps receives
// NUM_MAPS * 128 bytes.
// Returns 0, the failing CUresult, or -4 when the driver's encoder cannot
// be reached.
extern "C" int mlp_fwd_sm90_maps(const void* const* wts, void* maps) {
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
  for (int i = 0; i < NUM_MAPS; ++i) {
    const cuuint32_t n = i >= M_R0H ? RGB_WIDTH : WIDTH;
    const cuuint64_t kp = (i == M_T0 || i == M_F0E || i == M_R0D) ? KC : WIDTH;
    const cuuint64_t dims[2] = {kp, n}, strides[1] = {kp * 2};
    const cuuint32_t box[2] = {KC, n / HALVES}, steps[2] = {1, 1};
    CUtensorMap map;
    const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wts[i]),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)r;
    memcpy(static_cast<char*>(maps) + i * sizeof(CUtensorMap), &map, sizeof(CUtensorMap));
  }
  return 0;
}
