// TensoRF's shading chain, forward, on Hopper (sm_90a): the appearance
// products [P, 144], the rays' view directions [N, 3] (P = N S, point p on
// ray p / S), the basis and the three layers' weights (fp32) -> rgb [P, 3]
// (fp32). The layout and the numerics are tensorf_mlp_common.cuh's; the
// plain version is kernels/tensorf_mlp.py::mlp_plain. Replaces no TPU kernel
// (the JAX package has no TensoRF).
//
// What bounds it: a point's products are read once and its color written
// once, 588 bytes (0.17 ns at 3.35 TB/s), and it takes 42,496 multiply-adds
// on the tensor cores with the kernels' padding (39,856 without; 0.09 ns at
// 989 TFLOP/s): below the card's ridge, so the bytes are the floor. The
// features, the encodings and both hidden layers never leave the registers.
// What the design does about that:
//   * The products are read as 16-byte loads, four lanes to a row's 64
//     bytes, and rounded to bf16 as the first product's A fragments (the
//     basis's rows are packed in that order); nothing else is read per point
//     but the ray's direction (12 bytes a ray, from L2).
//   * One warp per 16 points through the whole chain, its accumulators
//     packed straight into the next layer's A fragments; no block-wide
//     barrier once the weights are in.
//   * The weights packed once a call as B fragments (tensorf_mlp_pack_kernel,
//     21,504 lanes' worth, 172 KB with the backward's transposes) and copied
//     into each block's shared memory by TMA bulk copies (the forward's 85
//     KB), so a fragment is one conflict-free 8-byte load; two blocks of 8
//     warps per SM.
// One launch of each kernel per call, no allocation: capturable in a CUDA
// graph. Deterministic: every sum runs in a fixed order.

#include "tensorf_mlp_common.cuh"

namespace tfm = tensorf_mlp;

namespace {

constexpr int FWD_WARPS = 8;

struct PackArgs {
  const float* basis;  // [144, 27]
  const float* w1;     // [150, 128]
  const float* w2;     // [128, 128]
  const float* w3;     // [128, 3]
  uint2* image;        // [ALL_FRAGS]
};

// B[k, n] of the packed matrix at `off` (module note of tensorf_mlp_common.cuh)
__device__ float packed_value(const PackArgs& a, int off, int k, int n) {
  using namespace tfm;
  if (off == OFF_BAS) return n < APP ? a.basis[k * APP + n] : 0.f;
  if (off == OFF_W1) {
    const int r = plain_row(k);
    return r >= 0 ? a.w1[r * WIDTH + n] : 0.f;
  }
  if (off == OFF_W2) return a.w2[k * WIDTH + n];
  if (off == OFF_W3) return n < RGB ? a.w3[k * RGB + n] : 0.f;
  if (off == OFF_W3T) return k < RGB ? a.w3[n * RGB + k] : 0.f;
  if (off == OFF_W2T) return a.w2[n * WIDTH + k];
  if (off == OFF_W1T) {  // only the slots of the features a carry a gradient
    const int r = plain_row(n);
    return (n & 31) < APP ? a.w1[r * WIDTH + k] : 0.f;
  }
  // OFF_BAST: basis^T, its columns (the products) in the stored order
  return k < APP ? a.basis[phys(n) * APP + k] : 0.f;
}

// One thread per uint2 of the image: lane (g, t) of (k-step kk, n-tile j)
// holds B[k, 8 j + g] at k = 16 kk + 2 t + {0, 1} (x) and 16 kk + 8 + 2 t +
// {0, 1} (y); the basis's k in the products' stored order.
__global__ void __launch_bounds__(256) tensorf_mlp_pack_kernel(const PackArgs a) {
  using namespace tfm;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ALL_FRAGS) return;
  constexpr int OFFS[8] = {OFF_BAS, OFF_W1, OFF_W2, OFF_W3, OFF_W3T, OFF_W2T, OFF_W1T, OFF_BAST};
  constexpr int NTS[8] = {4, 16, 16, 1, 16, 16, 20, 18};
  int m = 7;
  while (OFFS[m] > e) --m;
  const int local = e - OFFS[m], lane = local & 31, tile = local >> 5;
  const int kk = tile / NTS[m], j = tile % NTS[m], g = lane >> 2, t = lane & 3;
  const int n = 8 * j + g;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = 16 * kk + (i < 2 ? 2 * t + i : 8 + 2 * t + i - 2);  // logical k
    const int k = OFFS[m] == OFF_BAS ? phys(l) : l;
    v[i] = packed_value(a, OFFS[m], k, n);
  }
  a.image[e] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

struct FwdArgs {
  const float* prods;  // [P, 144]
  const float* dirs;   // [N, 3]
  const uint2* image;
  const float *b1, *b2, *b3;
  long long p;
  int s;               // samples a ray
  float* rgb;          // [P, 3]
};

struct NoKeep {
  __device__ __forceinline__ void begin(int) const {}
  __device__ __forceinline__ void operator()(int, int, const uint32_t (&)[4]) const {}
  __device__ __forceinline__ void flush(int) const {}
  __device__ __forceinline__ void features(const float (&)[4][4]) const {}
};

__global__ void __launch_bounds__(FWD_WARPS * 32, 2)
tensorf_mlp_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  tfm::stage_image(smem, a.image, tfm::FWD_BYTES, &bar);
  const tfm::Weights wt{reinterpret_cast<const uint2*>(smem), a.b1, a.b2, a.b3};
  const long long groups = (a.p + 15) / 16;
  const int warp = threadIdx.x >> 5;
  for (long long grp = (long long)blockIdx.x * FWD_WARPS + warp; grp < groups;
       grp += (long long)gridDim.x * FWD_WARPS) {
    const tfm::Rows r = tfm::rows_of(grp, a.p);
    float sg[4];
    uint32_t mask1[4], mask2[4];
    tfm::forward_rows(a.prods, a.dirs, a.s, wt, r, mask1, mask2, sg, NoKeep{});
    // columns 2 t, 2 t + 1 of both rows: lanes t = 0 (red, green) and 1 (blue)
    if (r.t < 2) {
      if (r.v0) {
        a.rgb[3 * r.r0 + 2 * r.t] = sg[0];
        if (r.t == 0) a.rgb[3 * r.r0 + 1] = sg[1];
      }
      if (r.v1) {
        a.rgb[3 * r.r1 + 2 * r.t] = sg[2];
        if (r.t == 0) a.rgb[3 * r.r1 + 1] = sg[3];
      }
    }
  }
}

int sm_count(int& n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// The packed image's bytes, which the wrapper allocates.
extern "C" void tensorf_mlp_fwd_sizes(int* image_bytes) { *image_bytes = tfm::ALL_BYTES; }

// Packs the weights into image [ALL_FRAGS] (uint2; the backward reads it
// too) and computes rgb [p, 3]. Returns 0 on success, a cudaError_t value if
// a launch failed, or -1 for sizes the kernels do not take (p < 1 or above
// 2^31 - 1, s < 1).
extern "C" int tensorf_mlp_fwd(const void* prods, const void* dirs, long long p, int s,
                               const void* basis, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* w3, const void* b3, void* image,
                               void* rgb, void* stream) {
  if (p < 1 || p > 0x7fffffffLL || s < 1) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PackArgs pk{static_cast<const float*>(basis), static_cast<const float*>(w1),
                    static_cast<const float*>(w2), static_cast<const float*>(w3),
                    static_cast<uint2*>(image)};
  tensorf_mlp_pack_kernel<<<(tfm::ALL_FRAGS + 255) / 256, 256, 0, st>>>(pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tensorf_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tfm::FWD_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  const int e = sm_count(sms);
  if (e != 0) return e;
  const long long warps = (p + 15) / 16;
  const long long need = (warps + FWD_WARPS - 1) / FWD_WARPS;
  const unsigned blocks = (unsigned)(need < 2LL * sms ? need : 2LL * sms);
  const FwdArgs fa{static_cast<const float*>(prods), static_cast<const float*>(dirs),
                   static_cast<const uint2*>(image), static_cast<const float*>(b1),
                   static_cast<const float*>(b2), static_cast<const float*>(b3), p, s,
                   static_cast<float*>(rgb)};
  tensorf_mlp_fwd_kernel<<<blocks, FWD_WARPS * 32, tfm::FWD_BYTES, st>>>(fa);
  return (int)cudaGetLastError();
}
