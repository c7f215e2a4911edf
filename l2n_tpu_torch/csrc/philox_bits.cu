// Raw Philox4x32-10 bits for the rng="tpu_hw" statistical gates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of tests/test_tpu_hw.py::draw_raw_bits (`kernel`,
// the pallas_call that seeds the core's hardware PRNG with two int32 seeds
// and draws k (h, 128) blocks of its raw bits). On the card the tpu_hw mode
// is Philox, so this writes (k, h, 128) 32-bit words from two 32-bit seeds
// in the samplers' own counter layout (pathtrace.cuh philox_bits_slot):
// draw i of lane p = row * 128 + column is word i & 3 of the block at key
// (seed0, seed1), counter (p, 0, i >> 2, 0).
//
// What bounds it on this card: at the sizes it runs ((4, 7360, 128): 15 MB)
// the 4 bytes written per word, against ~98 integer operations per Philox
// block (10 rounds of two 32x32 multiplies, each giving its low and high
// word, and four XORs, with nine key bumps), a quarter block per word.
// Design: one thread per (lane, block), consecutive threads on consecutive
// lanes; it evaluates its block once and stores its (up to) four words,
// one per draw (pathtrace.cuh philox_bits_slot), so each of the four
// stores of a warp coalesces within its draw; the seeds are read from
// device memory, so the wrapper never synchronises.

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__global__ void philox_bits_kernel(const int32_t* __restrict__ seeds, int k,
                                   int h, uint32_t* __restrict__ out) {
  const size_t per_draw = static_cast<size_t>(h) * kLanes;
  const size_t n = static_cast<size_t>((k + 3) / 4) * per_draw;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t pixel = static_cast<uint32_t>(i % per_draw);
  const uint32_t block = static_cast<uint32_t>(i / per_draw);
  uint32_t c[4] = {pixel, 0u, block, 0u};
  l2n::philox4x32_10(static_cast<uint32_t>(seeds[0]),
                     static_cast<uint32_t>(seeds[1]), c);
#pragma unroll
  for (uint32_t w = 0; w < 4; ++w) {
    size_t offset;
    if (l2n::philox_bits_slot(pixel, block, w, static_cast<uint32_t>(k),
                              per_draw, offset))
      out[offset] = c[w];
  }
}

}  // namespace

// seeds: two int32 on the device; out: (k, h, 128) 32-bit words on the
// device. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int l2n_philox_bits(const int32_t* seeds, int k, int h,
                               uint32_t* out, void* stream) {
  const size_t n = static_cast<size_t>((k + 3) / 4) * h * kLanes;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  philox_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, k, h, out);
  return static_cast<int>(cudaGetLastError());
}
