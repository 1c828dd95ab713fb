// The multiresolution hash grid's lookup (Mueller et al., Instant Neural
// Graphics Primitives, SIGGRAPH 2022, sec. 3), shared by hash_encode_fwd.cu
// (gathers and trilinear weights) and hash_encode_bwd.cu (the scatter-add
// into the table's gradient), so that both walk the same corners.
//
// A point x in [0, 1]^3 on level l of resolution N: pos = x * N per axis,
// the cell floor(pos) clamped to N - 1, the place frac = pos - cell; corner c
// (bit a set: the far vertex along axis a) weighs the product over x, y, z of
// frac or 1 - frac. Its entry: x + (N + 1) (y + (N + 1) z) on a dense level,
// else xor(x * 1, y * 2654435761, z * 805459861) & (T - 1) in uint32, plus the
// level's offset in the table. Every multiply and subtract is an explicit
// __fmul_rn / __fsub_rn, so that nvcc contracts none of them into an FMA: the
// cells, places and weights are those of the plain PyTorch version
// (ops/encoding.py::hash_encode_plain), operation by operation.
//
// No TPU kernel stands behind these: the JAX package has no hash encoding.

#pragma once

#include <cuda_runtime.h>

namespace hash_grid {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;

// The table's levels, passed by value as a kernel parameter (648 bytes), read
// in place as a __grid_constant__ (a level index that varies by thread would
// otherwise copy the struct into each thread's local memory).
struct Levels {
  int count;
  int res[MAX_LEVELS];
  int dense[MAX_LEVELS];
  unsigned mask[MAX_LEVELS];  // a hashed level's size - 1 (a power of two)
  long long offset[MAX_LEVELS];
};

// The host's copy of the caller's level arrays; false for sizes the kernels
// do not take.
inline bool make_levels(Levels& lv, int count, const int* res, const int* dense,
                        const unsigned* mask, const long long* offset) {
  if (count < 1 || count > MAX_LEVELS) return false;
  lv.count = count;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < count;
    lv.res[l] = on ? res[l] : 1;
    lv.dense[l] = on ? dense[l] : 1;
    lv.mask[l] = on ? mask[l] : 0u;
    lv.offset[l] = on ? offset[l] : 0;
    if (on && res[l] < 1) return false;
  }
  return true;
}

// The cell and the place in it of point p on a level of resolution res.
__device__ __forceinline__ void locate(const float p[3], int res, unsigned cell[3],
                                       float frac[3]) {
  const float n = (float)res;
  const float last = (float)(res - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(p[a], n);
    const float c = fminf(floorf(pos), last);
    cell[a] = (unsigned)c;
    frac[a] = __fsub_rn(pos, c);
  }
}

// The trilinear weight of corner c: ((w_x * w_y) * w_z).
__device__ __forceinline__ float corner_weight(int c, const float frac[3]) {
  const float wx = (c & 1) ? frac[0] : __fsub_rn(1.0f, frac[0]);
  const float wy = (c & 2) ? frac[1] : __fsub_rn(1.0f, frac[1]);
  const float wz = (c & 4) ? frac[2] : __fsub_rn(1.0f, frac[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The table row of corner c of the cell on level l.
__device__ __forceinline__ long long corner_entry(const Levels& lv, int l, int c,
                                                  const unsigned cell[3]) {
  const unsigned x = cell[0] + (c & 1u), y = cell[1] + ((c >> 1) & 1u),
                 z = cell[2] + ((c >> 2) & 1u);
  unsigned i;
  if (lv.dense[l]) {
    const unsigned n1 = (unsigned)lv.res[l] + 1u;
    i = x + n1 * (y + n1 * z);
  } else {
    i = ((x * 1u) ^ (y * 2654435761u) ^ (z * 805459861u)) & lv.mask[l];
  }
  return lv.offset[l] + (long long)i;
}

}  // namespace hash_grid
