// The winner-attribute recovery probe for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of benchmarks/onehot_recovery.py:
// `_kernel_carry` (:100) and `_kernel_onehot` (:112), pallas_call at :134.
// Both sweep S spheres for every lane of one (32, 128) block of rays in the
// assume_outside t1-only form and write six planes: t (3e38 on a miss), the
// winner's index as float (-1 on a miss), and its cx, cy, cz, r2:
//   * onehot_carry: the attributes carried through every candidate, from
//     (0, 0, 0, 1), so a miss leaves r2 = 1;
//   * onehot_gather: (t, index) only, the attributes read afterwards from
//     the (S, 8) table. The TPU recovered them with a one-hot matmul at
//     Precision.HIGHEST, an exact gather (0 on a miss); here it is four
//     loads of the winner's table row.
//
// What bounds them on this card: fp32 issue, ~19 operations and a sqrt per
// lane-candidate against 24 bytes read and 24 written per lane; at one
// block (4,096 lanes, 16 blocks of 256 threads on 132 SMs) launch latency
// and the serial chain of S candidates dominate. Design: one thread per
// lane; the sphere rows staged once per block into shared memory (a
// broadcast read per candidate); the body is csrc/sweep_probe.cuh's, which
// the CPU tests build with g++.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_probe.cuh"

namespace {

constexpr int kThreads = 256;

// rays: (6, lanes) ox, oy, oz, dx, dy, dz; spheres: (4, s) cx, cy, cz, r2;
// table: (s, 8), columns 0-3 cx, cy, cz, r2 (gather only); out: (6, lanes).
template <bool kCarry>
__device__ __forceinline__ void onehot_body(const float* __restrict__ rays,
                                            const float* __restrict__ spheres,
                                            int s,
                                            const float* __restrict__ table,
                                            int lanes,
                                            float* __restrict__ out) {
  extern __shared__ float rows[];
  for (int j = threadIdx.x; j < 4 * s; j += blockDim.x) rows[j] = spheres[j];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lanes) return;
  const l2n_probe::Spheres sc{rows, s};
  l2n_probe::Winner w = l2n_probe::sweep<kCarry, l2n_probe::T1Only>(
      sc, rays[p], rays[lanes + p], rays[2 * lanes + p], rays[3 * lanes + p],
      rays[4 * lanes + p], rays[5 * lanes + p], 1.0f);
  if (!kCarry) l2n_probe::gather(table, 8, 1, w);
  out[p] = w.t;
  out[lanes + p] = static_cast<float>(w.i);
  out[2 * lanes + p] = w.cx;
  out[3 * lanes + p] = w.cy;
  out[4 * lanes + p] = w.cz;
  out[5 * lanes + p] = w.r2;
}

// One kernel name per recovery, so that a profile tells them apart.
__global__ void onehot_carry_kernel(const float* __restrict__ rays,
                                    const float* __restrict__ spheres, int s,
                                    const float* __restrict__ table,
                                    int lanes, float* __restrict__ out) {
  onehot_body<true>(rays, spheres, s, table, lanes, out);
}

__global__ void onehot_gather_kernel(const float* __restrict__ rays,
                                     const float* __restrict__ spheres, int s,
                                     const float* __restrict__ table,
                                     int lanes, float* __restrict__ out) {
  onehot_body<false>(rays, spheres, s, table, lanes, out);
}

template <bool kCarry>
int launch(const float* rays, const float* spheres, int s, const float* table,
           int lanes, float* out, void* stream) {
  const dim3 grid(static_cast<unsigned>((lanes + kThreads - 1) / kThreads));
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kCarry) {
    onehot_carry_kernel<<<grid, kThreads, smem, st>>>(rays, spheres, s, table,
                                                      lanes, out);
  } else {
    onehot_gather_kernel<<<grid, kThreads, smem, st>>>(rays, spheres, s,
                                                       table, lanes, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers as above (table unused by the carry kernel). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int l2n_onehot_carry(const float* rays, const float* spheres,
                                int s, int lanes, float* out, void* stream) {
  return launch<true>(rays, spheres, s, nullptr, lanes, out, stream);
}

extern "C" int l2n_onehot_gather(const float* rays, const float* spheres,
                                 int s, const float* table, int lanes,
                                 float* out, void* stream) {
  return launch<false>(rays, spheres, s, table, lanes, out, stream);
}
