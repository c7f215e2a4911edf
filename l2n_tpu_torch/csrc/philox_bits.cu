// Raw Philox4x32-10 bits for the rng="tpu_hw" statistical gates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of tests/test_tpu_hw.py::draw_raw_bits (`kernel`,
// the pallas_call that seeds the core's hardware PRNG with two int32 seeds
// and draws k (h, 128) blocks of its raw bits). On the card the tpu_hw mode
// is Philox, so this writes (k, h, 128) 32-bit words from two 32-bit seeds
// in the samplers' own counter layout (pathtrace.cuh::philox_bits_word):
// draw i of lane p = row * 128 + column is word i & 3 of the block at key
// (seed0, seed1), counter (p, 0, i >> 2, 0).
//
// What bounds it on this card: integer operations, ~98 per Philox block (10
// rounds of two 32x32 multiplies, each giving its low and high word, and
// four XORs, with nine key bumps), against 4 bytes written per word. Design:
// one thread per output word, so consecutive threads store consecutive
// words and every store coalesces; a thread evaluates its whole block and
// keeps one word (four times the least arithmetic, kept simple); the seeds
// are read from device memory, so the wrapper never synchronises.

#include <cuda_runtime.h>

#include "pathtrace.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__global__ void philox_bits_kernel(const int32_t* __restrict__ seeds, int k,
                                   int h, uint32_t* __restrict__ out) {
  const size_t per_draw = static_cast<size_t>(h) * kLanes;
  const size_t n = static_cast<size_t>(k) * per_draw;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = l2n::philox_bits_word(static_cast<uint32_t>(seeds[0]),
                                 static_cast<uint32_t>(seeds[1]),
                                 static_cast<uint32_t>(i % per_draw),
                                 static_cast<uint32_t>(i / per_draw));
}

}  // namespace

// seeds: two int32 on the device; out: (k, h, 128) 32-bit words on the
// device. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int l2n_philox_bits(const int32_t* seeds, int k, int h,
                               uint32_t* out, void* stream) {
  const size_t n = static_cast<size_t>(k) * h * kLanes;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  philox_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, k, h, out);
  return static_cast<int>(cudaGetLastError());
}
