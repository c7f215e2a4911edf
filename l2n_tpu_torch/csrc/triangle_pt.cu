// Triangle path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel l2n_tpu/ops/kernels/triangle_pt.py::_kernel (the
// Pallas program per scheduled 32x128 tile, pallas_call in
// build_triangle_call). It computes the same step: for every pixel of the K
// scheduled tiles, `spp` samples (jittered primary ray,
// nearest triangle hit, at most `max_bounces` diffuse bounces with Russian
// roulette, any-hit test on the last segment, Mandelbrot sky on a miss, or
// the tex_coords / param_uv AOV of the primary hit), then accumulate into
// `accum` and write the tonemapped `output`, both IN PLACE.
//
// What bounds it on this card: fp32 ALU work in the triangle tests and the
// latency of the bound and triangle loads a thread walks through, not
// bandwidth (the default scene's 32,768 triangles are ~1.5 MB of slot rows
// plus ~2 MB of attributes, resident in the 50 MB L2). What the design does
// about that:
//   * one thread per pixel walks its own rays through the packed bound
//     hierarchy (mesh -> slab -> sub-cluster -> 16 triangles), pruning a
//     bound whose entry lies beyond the running best; the TPU kernel's
//     lockstep machinery (cone tables, flag passes, compaction, slab DMA,
//     the procedural shellwalk, certain-hit seeding) exists because a
//     (32,128) lane block must agree on one walk, and is not needed here;
//   * the per-mesh bounds, slab counts and albedo rows (8 floats per mesh)
//     are staged once per block into shared memory; slab and sub-cluster
//     bounds, slot rows (three 16-byte loads per triangle) and the winner's
//     attributes are read through the read-only data cache;
//   * attributes are interpolated once per ray, for the winner only.
// Simple first: no front-to-back mesh order, no cone culling of primaries,
// no slab-group level; a block is one row of one tile (tile_width threads),
// so the grid is K x tile_height.
//
// One instantiation per sampler (pathtrace.cuh::dispatch_rng), as in
// csrc/sphere_pt.cu: the stateful samplers' per-pixel state planes are
// loaded once per thread, stepped through its samples and stored once.
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the path body is in pathtrace.cuh, the traversal in
// triangle_pt.cuh.

#include <cuda_runtime.h>

#include "triangle_pt.cuh"

namespace {

template <class Rng>
__global__ void triangle_pt_kernel(l2n::PtParams p, int n_slabs, int tpad,
                                   const int32_t* __restrict__ sched,
                                   const float* __restrict__ mesh_bounds,
                                   const int32_t* __restrict__ slab_count,
                                   const float* __restrict__ slab_bounds,
                                   const float* __restrict__ sub_bounds,
                                   const float* __restrict__ tris,
                                   const float* __restrict__ attrs,
                                   const float* __restrict__ albedo,
                                   float* __restrict__ accum,
                                   float* __restrict__ output,
                                   uint32_t* __restrict__ rng_state) {
  extern __shared__ float smem[];
  const int m = p.n_scene;
  float* s_bounds = smem;                  // (M, 4)
  float* s_albedo = smem + 4 * m;          // (3, M)
  int32_t* s_scount = reinterpret_cast<int32_t*>(smem + 7 * m);  // (M,)
  for (int i = threadIdx.x; i < 4 * m; i += blockDim.x) s_bounds[i] = mesh_bounds[i];
  for (int i = threadIdx.x; i < 3 * m; i += blockDim.x) s_albedo[i] = albedo[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_scount[i] = slab_count[i];
  __syncthreads();

  const int tile = blockIdx.x / p.tile_height;
  const int local_row = blockIdx.x % p.tile_height;
  const int tile_x = sched[2 * tile];
  const int tile_y = sched[2 * tile + 1];
  const int row = tile_y * p.tile_height + local_row;
  const int col = tile_x * p.tile_width + static_cast<int>(threadIdx.x);
  l2n::TriSceneView scene;
  scene.n = m;
  scene.n_slabs = n_slabs;
  scene.tpad = tpad;
  scene.mesh_bounds = s_bounds;
  scene.slab_count = s_scount;
  scene.slab_bounds = slab_bounds;
  scene.sub_bounds = sub_bounds;
  scene.tris = tris;
  scene.attrs = attrs;
  scene.ar = s_albedo;
  scene.ag = s_albedo + m;
  scene.ab = s_albedo + 2 * m;
  l2n::render_pixel<Rng>(p, scene, row, col, accum, output, rng_state);
}

struct LaunchTrianglePt {
  template <class Rng>
  static int run(l2n::PtParams p, int n_slabs, int tpad, const int32_t* sched,
                 const float* mesh_bounds, const int32_t* slab_count,
                 const float* slab_bounds, const float* sub_bounds,
                 const float* tris, const float* attrs, const float* albedo,
                 float* accum, float* output, uint32_t* rng_state,
                 cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
    const dim3 block(static_cast<unsigned>(p.tile_width));
    const size_t smem = sizeof(float) * 8 * static_cast<size_t>(p.n_scene);
    triangle_pt_kernel<Rng><<<grid, block, smem, stream>>>(
        p, n_slabs, tpad, sched, mesh_bounds, slab_count, slab_bounds,
        sub_bounds, tris, attrs, albedo, accum, output, rng_state);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// Launch one step on `stream`. ip/fp: host arrays of l2n::kIntParams ints
// and l2n::kFloatParams floats (ip[5] = M meshes); n_slabs = S and tpad =
// S * 128 are the packed scene's slab capacity and slots per mesh. Device
// pointers: sched (K, 2) int32; mesh_bounds (M, 4), slab_count (M,) int32,
// slab_bounds (M, S, 5), sub_bounds (M, S, 8, 5), tris (M * tpad, 12),
// attrs (T, 16), albedo (3, M), accum (4, Hp, Wp), output (3, Hp, Wp)
// float32; rng_state (8 or 4, Hp, Wp) 32-bit words, null for the
// counter-based samplers. Returns cudaGetLastError() after the launch (0 on
// success), -1 for an unknown sampler code (ip[14]).
extern "C" int l2n_triangle_pt(const int32_t* ip, const float* fp,
                               int n_slabs, int tpad, const int32_t* sched,
                               const float* mesh_bounds,
                               const int32_t* slab_count,
                               const float* slab_bounds,
                               const float* sub_bounds, const float* tris,
                               const float* attrs, const float* albedo,
                               float* accum, float* output,
                               uint32_t* rng_state, void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_rng<LaunchTrianglePt>(
      p.rng, p, n_slabs, tpad, sched, mesh_bounds, slab_count, slab_bounds,
      sub_bounds, tris, attrs, albedo, accum, output, rng_state,
      static_cast<cudaStream_t>(stream));
}
