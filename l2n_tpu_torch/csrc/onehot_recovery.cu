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
//     Precision.HIGHEST, an exact gather (0 on a miss); here it is one
//     16-byte load of the winner's table row.
//
// What bounds them on this card: ~17 fp32 operations per lane-candidate
// (a sqrt and ~5 more only where the ray's line meets the sphere) against
// 24 bytes read and 24 written per lane; at 4,096 lanes a thread per lane
// fills 16 blocks of 132 SMs and runs a dependent chain of S candidates,
// and the whole probe's work is below a launch's own time.
// Design: each ray's sweep is split over a group of kGroup lanes of a warp
// (csrc/sweep_probe.cuh `split_sweep`): lane g sweeps spheres g, g + G, ...,
// and the group keeps the smaller t, then the smaller index, over log2(G)
// shuffle rounds, which is the serial sweep's winner to the bit (G = 16:
// 256 blocks, 8 candidates per lane); the spheres are staged once per block
// as 16-byte records in shared memory (one broadcast load per candidate);
// the sqrt is taken only on a real discriminant. Lane 0 of each group
// writes the six planes. The CPU tests build the same header with g++.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_probe.cuh"

namespace {

constexpr int kThreads = 256;
// Lanes per ray, measured on the card among 4, 8, 16 and 32 (PERF.md).
constexpr int kGroup = 16;
static_assert(kThreads % kGroup == 0, "a block holds whole groups");

// rays: (6, lanes) ox, oy, oz, dx, dy, dz; spheres: (4, s) cx, cy, cz, r2;
// table: (s, 8), columns 0-3 cx, cy, cz, r2, 16-byte aligned (gather only);
// out: (6, lanes).
template <bool kCarry>
__device__ __forceinline__ void onehot_body(const float* __restrict__ rays,
                                            const float* __restrict__ spheres,
                                            int s,
                                            const float* __restrict__ table,
                                            int lanes,
                                            float* __restrict__ out) {
  extern __shared__ l2n_probe::Sphere4 packed[];
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const bool live = p < lanes;
  // The ray's loads are issued before the barrier, beside the staging.
  float r[6] = {};
  if (live)
    for (int k = 0; k < 6; ++k) r[k] = rays[k * lanes + p];
  for (int j = threadIdx.x; j < s; j += blockDim.x)
    packed[j] = l2n_probe::packed_sphere(spheres, s, j);
  __syncthreads();
  if (!live) return;  // the whole group leaves together
  const int g = threadIdx.x % kGroup;
  l2n_probe::Winner w = l2n_probe::split_sweep<kCarry, kGroup>(
      packed, s, g, l2n_probe::group_mask<kGroup>(threadIdx.x % 32), r[0],
      r[1], r[2], r[3], r[4], r[5], 1.0f);
  if (g != 0) return;
  if (!kCarry) l2n_probe::gather_row(table, w);
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

int grid_for(int lanes) {
  return static_cast<int>(
      (static_cast<long long>(lanes) * kGroup + kThreads - 1) / kThreads);
}

template <bool kCarry>
int launch(const float* rays, const float* spheres, int s, const float* table,
           int lanes, float* out, void* stream) {
  const dim3 grid(static_cast<unsigned>(grid_for(lanes)));
  const size_t smem = sizeof(l2n_probe::Sphere4) * static_cast<size_t>(s);
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

// The launch shape at `lanes` lanes into shape[0..2]: lanes per ray (G),
// threads per block, blocks. Returns 0.
extern "C" int l2n_onehot_shape(int lanes, int* shape) {
  shape[0] = kGroup;
  shape[1] = kThreads;
  shape[2] = grid_for(lanes);
  return 0;
}
