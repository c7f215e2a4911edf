// Triangle path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel l2n_tpu/ops/kernels/triangle_pt.py::_kernel (the
// Pallas program per scheduled 32x128 tile, pallas_call in
// build_triangle_call). It computes the same step: for every pixel of the K
// scheduled tiles, `spp` samples (jittered primary ray, fovy or viewproj,
// nearest triangle hit, at most `max_bounces` diffuse bounces with Russian
// roulette, any-hit test on the last segment, Mandelbrot or sun sky on a
// miss; the procedural Lambert bounce or the microfacet / Disney
// materials, the bump and the explicit point and directional lights, whose
// shadow rays walk every mesh, next event estimation (cone sampling of the
// emissive meshes' bounding spheres, its sample traced through every mesh)
// and MIS, homogeneous fog (collision sampling per segment, Beer-Lambert
// shadow and light rays); or a primary-only AOV: the normal, with a
// magenta miss, hit,
// ambient occlusion, whose second cast is the same per-lane walk, or the
// tex_coords / param_uv of the primary hit), then accumulate into `accum`
// and write the tonemapped `output`, both IN PLACE. fast_math takes rsqrtf
// at the shared sites only (the camera ray and the scatter); the triangle
// tests stay exact.
//
// What bounds it on this card: fp32 ALU work in the bound and triangle
// tests and the latency of the loads a thread walks through, not bandwidth
// (the default scene's 32,768 triangles are ~1.5 MB of slot rows plus ~2 MB
// of attributes, resident in the 50 MB L2); and, under SIMT, divergence: a
// warp runs every loop body any of its lanes enters. What the design does
// about that:
//   * one thread per pixel walks its own rays through the packed bound
//     hierarchy (mesh -> slab -> sub-cluster -> 16 triangles; a mesh of
//     more than 8 slabs, such as a 70k-triangle OBJ's 548, tests the
//     spheres of its 8-slab groups first, the TPU kernel's slab-group
//     level, and then only the slabs of the groups it visits);
//   * each cast's walk starts from the certain-hit seed of the watertight
//     meshes whose bounds it enters from outside (the TPU kernel's
//     inscribed-sphere and interior-ball t_ub, csrc/triangle_pt.cuh
//     certain_hit), which prunes every bound beyond it; a cast that finds
//     nothing under its seed walks again unseeded, so the hit stays the
//     brute-force sweep's;
//   * primaries are cone-culled per tile (csrc/cull.cuh, the TPU kernel's
//     mesh visibility table): each block builds its tile's visible-mesh
//     list in its prologue (a warp ballot and a block prefix, ascending
//     order), and primary casts and the tex_coords / param_uv AOVs test
//     only those mesh bounds;
//   * per lane, the meshes a ray enters are kept in a short list sorted
//     front to back by entry distance (the per-ray counterpart of the TPU
//     kernel's mesh_order), then walked by ONE loop over the lane's own
//     (mesh, slab, sub-cluster) work items, bound tests until a
//     sub-cluster to sweep, then its 16 triangles (Aila & Laine's
//     "while-while" traversal): a warp pays for its longest lane's walk
//     instead of the union of its lanes' meshes, and near hits prune the
//     farther meshes early (`enter <= best`). The winner rule is order-
//     independent, so the hit is the brute-force sweep's in any order;
//   * the per-mesh bounds, slab counts, albedo rows and the visible list
//     (9 words per mesh; 15 with the material rows, which only the
//     materials body and the bumped normal AOV stage) are staged once per
//     block into shared memory; the
//     slab and sub-cluster bounds, slot rows (three 16-byte loads per
//     triangle) and the winner's attributes are read through the read-only
//     data cache: staging the slab bounds too gained nothing, and staging
//     the default scene's 41 KB of sub-cluster bounds per block cost more
//     than it saved (PERF.md §6 keeps the three times);
//   * attributes are interpolated once per ray, for the winner only;
//   * a block covers 4 rows x tile_width / 4 columns of a tile where its
//     shape allows, a warp 4 x 8 pixels (l2n::block_pixel): a warp's bounce
//     rays start in the same few meshes and walk the same sub-clusters;
//   * registers are capped at 80 so that six blocks fit on an SM (the
//     walk is latency-bound; 64 and 72 spill and are faster at whole frame
//     but slower at the reference's 10 tiles); the materials, NEE and
//     fog bodies, whose path state spills at that cap, call each cast's
//     walk out of line (TriSceneViewT<true>), the Lambert and AOV bodies
//     inline it.
// Not done: the TPU kernel's procedural shellwalk and its disjoint-sphere
// sweeps (ROADMAP Queue 2 #5, #6); its certain-hit shortcut for the last
// segment's any-hit (a hit declared without a walk) is not taken, as it
// would change pixels against the brute-force sweep. The grid is K x
// tile_height blocks of tile_width threads.
//
// Twelve instantiations per sampler (pathtrace.cuh::dispatch_fused), as in
// csrc/sphere_pt.cu: the Lambert path tracer, the primary-only AOVs, whose
// ambient-occlusion walk so adds no code, and no register, to the path
// tracer's, and the materials path tracer; each with fast_math and the
// camera form compiled in; and the NEE path tracer and the fog path tracer
// once per counter-based sampler (their options read at run time), whose
// light bounds are the staged mesh bounds and which spill more under the
// 80-register cap. The
// stateful samplers' per-pixel state planes are loaded once per thread,
// stepped through its samples and stored once.
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the path body is in pathtrace.cuh, the traversal in
// triangle_pt.cuh.

#include <cuda_runtime.h>

#include "triangle_pt.cuh"

namespace {

// Threads of a block (tile_width pixels of one tile, l2n::block_pixel)
// build the tile's visible-mesh list over the staged mesh bounds, then
// render their pixels. Registers are
// capped at 80 (93-99 uncapped): six 128-thread blocks per SM instead of
// five hide more of the walk's load latency.
template <class Rng, int kBody, bool kFast, bool kViewproj>
__global__ void __maxnreg__(80)
triangle_pt_kernel(l2n::PtParams params, int n_slabs, int tpad,
                   const int32_t* __restrict__ sched,
                   const float* __restrict__ mesh_bounds,
                   const int32_t* __restrict__ slab_count,
                   const float* __restrict__ slab_bounds,
                   const float* __restrict__ sub_bounds,
                   const float* __restrict__ group_bounds,
                   const float* __restrict__ inner_gap,
                   const float* __restrict__ balls,
                   const float* __restrict__ tris,
                   const float* __restrict__ attrs,
                   const float* __restrict__ albedo,
                   const float* __restrict__ material,
                   float* __restrict__ accum, float* __restrict__ output,
                   uint32_t* __restrict__ rng_state) {
  extern __shared__ float smem[];
  const l2n::PtParams p =
      l2n::body_options<kBody, kFast, kViewproj>(params);
  const int m = p.n_scene;
  const int table = l2n::table_rows<kBody>(p);  // 3, or 9 with materials
  float* s_bounds = smem;                  // (M, 4)
  float* s_table = smem + 4 * m;           // (3, M) albedo, (6, M) material
  int32_t* s_scount =
      reinterpret_cast<int32_t*>(smem + (4 + table) * m);  // (M,)
  int32_t* s_vis = s_scount + m;           // (M,) visible meshes
  int32_t* s_counts = s_vis + m;           // 33 ints for the compaction
  for (int i = threadIdx.x; i < 4 * m; i += blockDim.x) s_bounds[i] = mesh_bounds[i];
  for (int i = threadIdx.x; i < 3 * m; i += blockDim.x) s_table[i] = albedo[i];
  for (int i = threadIdx.x; i < (table - 3) * m; i += blockDim.x)
    s_table[3 * m + i] = material[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_scount[i] = slab_count[i];
  __syncthreads();

  const int tile = blockIdx.x / p.tile_height;
  const int tile_x = sched[2 * tile];
  const int tile_y = sched[2 * tile + 1];
  const l2n::TileCone cone = l2n::tile_cone(p, tile_x, tile_y);
  const int n_vis = l2n::build_visible_block(
      p, cone,
      [&](int i, float& cx, float& cy, float& cz, float& r2) {
        cx = s_bounds[4 * i];
        cy = s_bounds[4 * i + 1];
        cz = s_bounds[4 * i + 2];
        r2 = s_bounds[4 * i + 3];
      },
      m, s_vis, s_counts);

  l2n::TriSceneViewT<kBody == l2n::kBodyMaterials ||
                     kBody == l2n::kBodyNee || kBody == l2n::kBodyFog>
      scene;
  scene.n = m;
  scene.n_slabs = n_slabs;
  scene.tpad = tpad;
  scene.mesh_bounds = s_bounds;
  scene.slab_count = s_scount;
  scene.slab_bounds = slab_bounds;
  scene.sub_bounds = sub_bounds;
  scene.group_bounds = group_bounds;
  scene.inner_gap = inner_gap;
  scene.balls = balls;
  scene.tris = tris;
  scene.attrs = attrs;
  scene.ar = s_table;
  scene.ag = s_table + m;
  scene.ab = s_table + 2 * m;
  scene.mat = s_table + 3 * m;
  scene.vis = s_vis;
  scene.n_vis = n_vis;
  int r, c;
  l2n::block_pixel(p, blockIdx.x % p.tile_height, threadIdx.x, r, c);
  l2n::render_pixel<Rng, kBody>(p, scene, tile_y * p.tile_height + r,
                                tile_x * p.tile_width + c, accum, output,
                                rng_state);
}

// Shared memory of a block for M meshes with `table` rows of the per-mesh
// table: 6 + table words per mesh and 33 more.
size_t smem_bytes(int m, int table) {
  return sizeof(float) * ((6 + table) * static_cast<size_t>(m) + 33);
}

struct LaunchTrianglePt {
  template <class Rng, int kBody, bool kFast, bool kViewproj>
  static int run(l2n::PtParams p, int n_slabs, int tpad, const int32_t* sched,
                 const float* mesh_bounds, const int32_t* slab_count,
                 const float* slab_bounds, const float* sub_bounds,
                 const float* group_bounds, const float* inner_gap,
                 const float* balls, const float* tris, const float* attrs,
                 const float* albedo, const float* material, float* accum,
                 float* output, uint32_t* rng_state, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
    const dim3 block(static_cast<unsigned>(p.tile_width));
    const size_t smem = smem_bytes(p.n_scene, l2n::table_rows<kBody>(p));
    // Opt in to more than 48 KiB once per instantiation (not again while a
    // CUDA graph captures the launch).
    static size_t opted = 48 * 1024;
    if (smem > opted) {
      const cudaError_t rc = cudaFuncSetAttribute(
          triangle_pt_kernel<Rng, kBody, kFast, kViewproj>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
      opted = smem;
    }
    triangle_pt_kernel<Rng, kBody, kFast, kViewproj>
        <<<grid, block, smem, stream>>>(
        p, n_slabs, tpad, sched, mesh_bounds, slab_count, slab_bounds,
        sub_bounds, group_bounds, inner_gap, balls, tris, attrs, albedo,
        material, accum, output, rng_state);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// Launch one step on `stream`. ip/fp: host arrays of l2n::kIntParams ints
// and l2n::kFloatParams floats (ip[5] = M meshes); n_slabs = S and tpad =
// S * 128 are the packed scene's slab capacity and slots per mesh. Device
// pointers: sched (K, 2) int32; mesh_bounds (M, 4), slab_count (M,) int32,
// slab_bounds (M, S, 5), sub_bounds (M, S, 8, 5), group_bounds (M,
// ceil(S / 8), 5), inner_gap (M,), balls (M, 8, 4), tris (M * tpad, 12),
// attrs (T, 16), albedo (3, M), material (6, M), lights (n_point + n_dir,
// 6; null without lights), accum (4, Hp, Wp), output (3, Hp, Wp) float32;
// rng_state (8 or 4, Hp, Wp) 32-bit words, null for the counter-based
// samplers. Returns cudaGetLastError() after the launch (0 on success), -1
// for an unknown sampler code (ip[14]).
extern "C" int l2n_triangle_pt(const int32_t* ip, const float* fp,
                               int n_slabs, int tpad,
                               const int32_t* sched,
                               const float* mesh_bounds,
                               const int32_t* slab_count,
                               const float* slab_bounds,
                               const float* sub_bounds,
                               const float* group_bounds,
                               const float* inner_gap, const float* balls,
                               const float* tris, const float* attrs,
                               const float* albedo, const float* material,
                               const float* lights, float* accum,
                               float* output, uint32_t* rng_state,
                               void* stream) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  p.lights = lights;
  return l2n::dispatch_fused<LaunchTrianglePt>(
      p, p, n_slabs, tpad, sched, mesh_bounds, slab_count, slab_bounds,
      sub_bounds, group_bounds, inner_gap, balls, tris, attrs, albedo,
      material, accum, output, rng_state, static_cast<cudaStream_t>(stream));
}
