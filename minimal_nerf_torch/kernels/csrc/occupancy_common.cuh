// The occupancy bit of one cell of the packed G^3 grid, the one definition
// of the probe shared by occupancy_probe.cu (the standalone probe) and
// occupancy_sampler.cu (the fused coarse sampler).
//
// words [G^3 / 32] hold the JAX uint32 bit pattern (int32 in PyTorch): bit
// idx & 31 of word idx >> 5 is cell idx, the C-order linear index
// (x * G + y) * G + z. An index outside [0, n_bits) gives 0 and reads
// nothing, as the TPU kernel's zero-padded table gives 0 there. Each word is
// read through the read-only path (__ldg): the table (32 KiB at G=64,
// 256 KiB at G=128) stays in L1/L2 across the probes.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int occupancy_bit(const unsigned* __restrict__ words,
                                             long long n_bits, int idx) {
  if (idx < 0 || (long long)idx >= n_bits) return 0;
  return (int)((__ldg(words + (idx >> 5)) >> (idx & 31)) & 1u);
}
