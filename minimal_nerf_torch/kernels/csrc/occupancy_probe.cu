// Occupancy bin probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_probe_kernel` of
// minimal_nerf_tpu/kernels/occupancy_probe.py (public as `probe_bits_pallas`,
// reached from `ops/occupancy.py::query_bin_weights`): the occupancy bit of
// each probe of the packed G^3 grid,
//   bits[i] = (words[lin[i] >> 5] >> (lin[i] & 31)) & 1,
// for words [G^3 / 32] (32-bit, the JAX uint32 bit pattern held in int32) and
// int32 linear cell indices lin of any count P; bits are int32 0/1. An index
// outside [0, 32 * n_words) gives 0 and reads nothing (the TPU kernel's
// zero-padded table gives 0 there too).
//
// What bounds it: bytes. Each probe reads 4 B of lin and writes 4 B of bits;
// the table (32 KiB at G=64) is read once from device memory and then hit in
// L1/L2. A 4096-ray x 64-bin chunk is 262,144 probes, ~2.1 MB: ~0.6 us at
// 3.35 TB/s, below the cost of a launch.
//
// Design: a direct gather in place of the TPU's one-hot matmul against a u16
// table (a workaround for the TPU's missing gather unit). One thread takes 4
// consecutive probes with one 16-byte load of lin and one 16-byte store of
// bits (scalar accesses for a ragged tail or unaligned pointers) and reads
// each word through the read-only path (__ldg; occupancy_common.cuh, shared
// with the fused sampler). No padding of P to blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "occupancy_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;

__global__ void __launch_bounds__(THREADS)
    probe_kernel(const unsigned* __restrict__ words, long long n_bits,
                 const int* __restrict__ lin, int* __restrict__ bits, long long p, int vec) {
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * PER_THREAD;
  if (i0 >= p) return;
  if (vec && i0 + PER_THREAD <= p) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(lin + i0));
    int4 r;
    r.x = occupancy_bit(words, n_bits, v.x);
    r.y = occupancy_bit(words, n_bits, v.y);
    r.z = occupancy_bit(words, n_bits, v.z);
    r.w = occupancy_bit(words, n_bits, v.w);
    *reinterpret_cast<int4*>(bits + i0) = r;
  } else {
    const long long end = i0 + PER_THREAD < p ? i0 + PER_THREAD : p;
    for (long long i = i0; i < end; ++i) bits[i] = occupancy_bit(words, n_bits, __ldg(lin + i));
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t value if the launch failed, or -1 for
// sizes the kernel does not take.
extern "C" int occupancy_probe(const void* words, long long n_words, const void* lin, void* bits,
                               long long p, void* stream) {
  if (n_words < 1 || p < 1) return -1;
  const long long groups = (p + PER_THREAD - 1) / PER_THREAD;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  const int vec = (reinterpret_cast<uintptr_t>(lin) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(bits) % 16 == 0);
  probe_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), 32LL * n_words, static_cast<const int*>(lin),
      static_cast<int*>(bits), p, vec);
  return (int)cudaGetLastError();
}
