// Sphere path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel l2n_tpu/ops/kernels/sphere_pt.py::_kernel (the
// Pallas program per scheduled 32x128 tile, pallas_call in
// build_sphere_call). It computes the same step: for every pixel of the K
// scheduled tiles, `spp` threefry-keyed samples (jittered primary ray,
// nearest-sphere sweep, at most `max_bounces` diffuse bounces with Russian
// roulette, any-hit test on the last segment, Mandelbrot sky on a miss),
// then accumulate into `accum` and write the tonemapped `output`, both IN
// PLACE (the counterpart of the JAX step's donated buffers).
//
// What bounds it on this card: fp32 ALU and SFU throughput, not memory. A
// sample costs about 3 sweeps x 128 spheres (~20 flops and a sqrt each) plus
// up to 64 Mandelbrot iterations, against 28 bytes read and written per
// pixel-step (accum 16 B in and out, output 12 B out). What the design does
// about that:
//   * one thread per pixel, so a thread exits when its path dies (emissive
//     hit, miss, roulette) instead of running masked lanes as the TPU's
//     lockstep tiles must; the sky's escape loop runs only for paths that
//     end on a miss, behind an exact direction-box test;
//   * the sphere SoA and albedo table (7 x n floats) are staged once per
//     block into shared memory: every thread of a warp reads the same
//     sphere in a sweep, a broadcast;
//   * the camera and step constants travel by value in the parameter block.
// Simple first: no cone culling of primaries, no wgmma/TMA; a block is one
// row of one tile (tile_width threads), so the grid is K x tile_height.
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the per-pixel path body is in pathtrace.cuh, the sweeps in
// sphere_pt.cuh.

#include <cuda_runtime.h>

#include "sphere_pt.cuh"

namespace {

__global__ void sphere_pt_kernel(l2n::PtParams p,
                                 const int32_t* __restrict__ sched,
                                 const float* __restrict__ spheres,
                                 float* __restrict__ accum,
                                 float* __restrict__ output) {
  extern __shared__ float smem[];
  const int words = 7 * p.n_scene;
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = spheres[i];
  __syncthreads();

  const int tile = blockIdx.x / p.tile_height;
  const int local_row = blockIdx.x % p.tile_height;
  const int tile_x = sched[2 * tile];
  const int tile_y = sched[2 * tile + 1];
  const int row = tile_y * p.tile_height + local_row;
  const int col = tile_x * p.tile_width + static_cast<int>(threadIdx.x);
  const l2n::SceneView scene = l2n::scene_view(smem, p.n_scene);
  l2n::render_pixel(p, scene, row, col, accum, output);
}

}  // namespace

// Launch one step on `stream`. ip/fp: host arrays of l2n::kIntParams ints and
// l2n::kFloatParams floats; sched (K, 2) int32, spheres (7, n) float32,
// accum (4, Hp, Wp) and output (3, Hp, Wp) float32 are device pointers.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int l2n_sphere_pt(const int32_t* ip, const float* fp,
                             const int32_t* sched, const float* spheres,
                             float* accum, float* output, void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
  const dim3 block(static_cast<unsigned>(p.tile_width));
  const size_t smem = sizeof(float) * 7 * static_cast<size_t>(p.n_scene);
  sphere_pt_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      p, sched, spheres, accum, output);
  return static_cast<int>(cudaGetLastError());
}
