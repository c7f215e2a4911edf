// Sphere path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel l2n_tpu/ops/kernels/sphere_pt.py::_kernel (the
// Pallas program per scheduled 32x128 tile, pallas_call in
// build_sphere_call). It computes the same step: for every pixel of the K
// scheduled tiles, `spp` samples (jittered primary ray, fovy or viewproj,
// nearest-sphere sweep, at most `max_bounces` diffuse bounces with Russian
// roulette, any-hit test on the last segment, Mandelbrot or sun sky on a
// miss; the procedural Lambert bounce or the microfacet / Disney materials,
// the bump, the explicit point and directional lights, next event
// estimation (area sampling of the emissive spheres) and MIS, homogeneous
// fog (collision sampling, Beer-Lambert shadow and light rays); or one of the
// primary-only AOVs: normal, hit, ambient occlusion, tex_coords /
// param_uv), then accumulate into `accum` and write the
// tonemapped `output`, both IN PLACE (the counterpart of the JAX step's
// donated buffers). fast_math takes rsqrtf at the JAX kernel's sites
// (csrc/pathtrace.cuh).
//
// What bounds it on this card: fp32 ALU and SFU throughput, not memory. A
// sample casts ~1.25 rays; a bounce or any-hit cast tests all 128 spheres
// (~24 operations and a sqrt each), plus up to 64 Mandelbrot iterations,
// against 28 bytes read and written per pixel-step (accum 16 B in and out,
// output 12 B out). What the design does about that:
//   * one thread per pixel, so a thread exits when its path dies (emissive
//     hit, miss, roulette) instead of running masked lanes as the TPU's
//     lockstep tiles must; the sky's escape loop runs only for paths that
//     end on a miss, behind an exact direction-box test;
//   * primaries are cone-culled per tile (csrc/cull.cuh, the TPU kernel's
//     visibility table): each block tests its tile's cone against every
//     sphere in its prologue and compacts the visible ones into shared
//     memory in ascending index order (a warp ballot and a block prefix),
//     with their origin terms o - c and |o - c|^2 - r^2, the same floats for
//     every primary, computed once; the primary sweep visits only that list
//     (a handful of the 128 spheres on the default view) and, as it keeps
//     the first index of the minimum t, finds the full sweep's hit;
//   * every sweep keeps (t, index) and reads the winner's centre and r^2
//     once afterwards (the gather form, faster than carrying them in the
//     PR 5 probes), and skips a sphere's square root and roots when no
//     lane of the warp has a real root (a warp vote; the lane's own miss
//     is a NaN comparison anyway): bounce rays are incoherent, but most
//     of the 128 spheres miss all of a warp's lines;
//   * the sphere SoA and albedo table (7 x n floats) are staged once per
//     block into shared memory: every thread of a warp reads the same
//     sphere in a sweep, a broadcast;
//   * the step constants travel by value in the parameter block, and the
//     camera in constant memory, copied there from the step's device buffer
//     ahead of each launch (pathtrace.cuh stage_camera): a CUDA graph of
//     the step serves every camera pose;
//   * a block is tile_width pixels of one tile, 4 rows x tile_width / 4
//     columns where the tile's shape allows, a warp 4 x 8 pixels
//     (l2n::block_pixel): a warp's bounce rays start close together, so
//     more spheres miss all of them. The grid is K x tile_height blocks,
//     so each of a tile's 32 blocks builds the tile's list, which costs
//     less than giving a block more pixels (PERF.md, PR 6).
// Not done: no tensor-core sweep (ROADMAP Queue 3 #14), no TMA.
//
// Twelve instantiations per sampler (pathtrace.cuh::dispatch_fused): the
// Lambert path tracer, the primary-only AOVs and the materials path tracer,
// so that the default path tracer's code holds no AOV, no material and no
// NEE path, each with fast_math and the camera form compiled in
// (pathtrace.cuh::with_options); and the NEE path tracer (the materials
// body with next event estimation and MIS) and the fog path tracer (the
// materials body with fog, NEE and MIS read at run time), each once per
// counter-based sampler with both read at run time (body_options). Only the materials and NEE
// bodies and the bumped normal AOV stage the six material rows of the
// table; they read the explicit lights from a small device buffer, and each
// light and each NEE sample casts its shadow ray with the nearest-hit sweep
// over every sphere (the culled list serves the camera's rays only); NEE's
// light spheres are the staged rows e * emissive_every, and a sample whose
// weight is 0 (the light behind the vertex or facing away) casts nothing.
// The samplers: threefry, Philox
// (rng="tpu_hw"), and the stateful TinyMT and TausLCG, whose per-pixel
// state planes a thread loads once, steps through its `spp` samples and
// stores once (the JAX kernel's aliased rng planes).
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the per-pixel path body is in pathtrace.cuh, the sweeps in
// sphere_pt.cuh.

#include <cuda_runtime.h>

#include "sphere_pt.cuh"

namespace {

// A block is tile_width pixels of one tile (l2n::block_pixel): it stages
// the scene, builds the tile's visible list and the list's origin terms
// (l2n::stage_culled_scene), then renders its pixels.
template <class Rng, int kBody, bool kFast, bool kViewproj>
__global__ void sphere_pt_kernel(l2n::PtParams params,
                                 const int32_t* __restrict__ sched,
                                 const float* __restrict__ spheres,
                                 float* __restrict__ accum,
                                 float* __restrict__ output,
                                 uint32_t* __restrict__ rng_state) {
  extern __shared__ float smem[];
  const l2n::PtParams p =
      l2n::body_options<kBody, kFast, kViewproj>(params);
  const int tile = blockIdx.x / p.tile_height;
  const int tile_x = sched[2 * tile];
  const int tile_y = sched[2 * tile + 1];
  // The table rows the body reads (l2n::table_rows), as a compile-time
  // count: the bumped normal AOV's 9 picked at run time.
  const l2n::SceneView scene =
      kBody == l2n::kBodyAovs && p.normal_map > 0.0f
          ? l2n::stage_culled_scene<9>(p, spheres, smem, tile_x, tile_y)
          : l2n::stage_culled_scene<l2n::reads_materials(kBody) ? 9 : 3>(
                p, spheres, smem, tile_x, tile_y);
  int r, c;
  l2n::block_pixel(p, blockIdx.x % p.tile_height, threadIdx.x, r, c);
  l2n::render_pixel<Rng, kBody>(p, scene, tile_y * p.tile_height + r,
                                tile_x * p.tile_width + c, accum, output,
                                rng_state);
}

struct LaunchSpherePt {
  template <class Rng, int kBody, bool kFast, bool kViewproj>
  static int run(l2n::PtParams p, const int32_t* sched,
                 const float* spheres, float* accum, float* output,
                 uint32_t* rng_state, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
    const dim3 block(static_cast<unsigned>(p.tile_width));
    const size_t smem = sizeof(float) * l2n::culled_scene_floats(
                                            p.n_scene, l2n::table_rows<kBody>(p));
    static size_t opted = 48 * 1024;
    const auto kernel = sphere_pt_kernel<Rng, kBody, kFast, kViewproj>;
    const cudaError_t rc = l2n::allow_smem(kernel, smem, opted);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<grid, block, smem, stream>>>(
        p, sched, spheres, accum, output, rng_state);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// Launch one step on `stream`, after staging the camera. ip/fp: host arrays
// of l2n::kIntParams ints and l2n::kFloatParams floats (ip[14] the sampler
// code, ip[18..19] the light counts); camera the packed (10, 4) float32
// block, sched (K, 2) int32, spheres (13, n) float32, lights (n_point +
// n_dir, 6) float32 (null without lights), accum (4, Hp, Wp) and output
// (3, Hp, Wp) float32 and rng_state (8 or 4, Hp, Wp) 32-bit words, null
// for the counter-based samplers, are device pointers. Returns
// cudaGetLastError() after the launch (0 on success), -1 for an unknown
// sampler code.
extern "C" int l2n_sphere_pt(const int32_t* ip, const float* fp,
                             const float* camera, const int32_t* sched,
                             const float* spheres, const float* lights,
                             float* accum, float* output,
                             uint32_t* rng_state, void* stream) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp, camera);
  p.lights = lights;
  const cudaError_t rc =
      l2n::stage_camera(camera, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return l2n::dispatch_fused<LaunchSpherePt>(
      p, p, sched, spheres, accum, output, rng_state,
      static_cast<cudaStream_t>(stream));
}
