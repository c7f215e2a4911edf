// The branch-cost probe for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/cond_cost.py:31 `_kernel` (pallas_call
// at :59): a grid of programs, each running REPS copies of one structure
// over the same (32, 128) float32 block and writing it to the one output
// block every program shares:
//   * work (mode 0): W chained acc = acc * 1.0000001f + 1e-9f (two
//     roundings: the library builds with -fmad=false);
//   * any (1): a vote over the whole block (jnp.any is block-wide, so it is
//     __syncthreads_or, not a warp vote), adding 1e-9f where it holds;
//   * cond_taken (2) / cond_skipped (3): the vote (acc > -1e30 somewhere,
//     always true; acc > 1e30 somewhere, always false), M carries
//     acc + i, and W chained FMAs on carry 0 behind `if (pred)`.
// Carries 1..M-1 never reach the output, so nvcc deletes them, as the
// function allows: M is a template parameter, so each carry is a register
// value that dead-code elimination removes (ptxas' register count shows
// it). Every block stores its result: if only one did, nvcc could skip the
// others' work.
//
// What bounds it on this card: fp32 issue for work and cond_taken at large
// W; for any and cond_skipped, the block-wide barrier and the launch.
// Bytes are nil (16 KiB in, 16 KiB out, however large the grid). Design: one
// block of 1,024 threads per program, 4 elements (one float4) per thread,
// so a program is one CUDA block as it is one TPU grid step; 256 programs
// fill 132 SMs with one 1,024-thread block each (two on some).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // 4,096 elements: one (32, 128) block
constexpr int kWork = 0, kAny = 1, kCondTaken = 2, kCondSkipped = 3;

__device__ __forceinline__ float fma_chain(float h, int w) {
  for (int k = 0; k < w; ++k) h = h * 1.0000001f + 1e-9f;
  return h;
}

template <int kMode, int kCarry>
__global__ void cond_cost_kernel(const float4* __restrict__ x, int w, int reps,
                                 float4* __restrict__ out) {
  const float4 v = x[threadIdx.x];
  float acc[4] = {v.x, v.y, v.z, v.w};
  for (int r = 0; r < reps; ++r) {
    if (kMode == kWork) {
      for (int e = 0; e < 4; ++e) acc[e] = fma_chain(acc[e], w);
    } else if (kMode == kAny) {
      const int local = acc[0] > -1e30f || acc[1] > -1e30f ||
                        acc[2] > -1e30f || acc[3] > -1e30f;
      const float add = __syncthreads_or(local) ? 1e-9f : 0.0f;
      for (int e = 0; e < 4; ++e) acc[e] = acc[e] + add;
    } else {
      const float lim = kMode == kCondTaken ? -1e30f : 1e30f;
      const int local = acc[0] > lim || acc[1] > lim || acc[2] > lim ||
                        acc[3] > lim;
      const bool pred = __syncthreads_or(local) != 0;
      for (int e = 0; e < 4; ++e) {
        float carry[kCarry];
        for (int i = 0; i < kCarry; ++i)
          carry[i] = acc[e] + static_cast<float>(i);
        if (pred) carry[0] = fma_chain(carry[0], w);
        acc[e] = carry[0];
      }
    }
  }
  out[threadIdx.x] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int kMode, int kCarry>
int launch(const float* x, int w, int grid, int reps, float* out,
           cudaStream_t stream) {
  cond_cost_kernel<kMode, kCarry><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), w, reps,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_cond(int m, const float* x, int w, int grid, int reps, float* out,
                cudaStream_t stream) {
  switch (m) {
    case 1: return launch<kMode, 1>(x, w, grid, reps, out, stream);
    case 3: return launch<kMode, 3>(x, w, grid, reps, out, stream);
    case 6: return launch<kMode, 6>(x, w, grid, reps, out, stream);
    case 12: return launch<kMode, 12>(x, w, grid, reps, out, stream);
    case 20: return launch<kMode, 20>(x, w, grid, reps, out, stream);
    default: return -1;
  }
}

}  // namespace

// x, out: (1, 32, 128) float32 on the device; mode 0-3 as above; m the
// carry count of the cond modes (1, 3, 6, 12 or 20; ignored otherwise).
// Returns cudaGetLastError() after the launch (0 on success), -1 for a mode
// or carry count without an instantiation.
extern "C" int l2n_cond_cost(const float* x, int mode, int m, int w, int grid,
                             int reps, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kWork: return launch<kWork, 1>(x, w, grid, reps, out, s);
    case kAny: return launch<kAny, 1>(x, w, grid, reps, out, s);
    case kCondTaken: return launch_cond<kCondTaken>(m, x, w, grid, reps, out, s);
    case kCondSkipped:
      return launch_cond<kCondSkipped>(m, x, w, grid, reps, out, s);
    default: return -1;
  }
}
