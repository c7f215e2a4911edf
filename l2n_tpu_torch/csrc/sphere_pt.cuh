// The sphere scene of the sphere path-tracing kernel (csrc/sphere_pt.cu):
// the nearest-hit and any-hit sweeps over the sphere SoA that the shared
// path body (csrc/pathtrace.cuh) calls.
//
// `__host__ __device__` like the path body: the CPU tests build this header
// with g++ against the plain torch path. The sweeps are the JAX package's
// half-b form (ops/intersect.py) in the same order of operations.
//
// The sweeps keep only (t, index) in the loop and read the winner's centre
// and r^2 once afterwards (the gather form), and skip a sphere's square
// root when no lane of the warp needs it. A primary cast may sweep only
// the tile's cone-visible spheres (csrc/cull.cuh), whose origin terms
// o - c and |o - c|^2 - r^2 are the same floats for every primary and are
// computed once per block (`Primaries`). The block prologue that builds them
// (stage_culled_scene) is shared by sphere_pt's kernel and the wavefront's
// pass A (csrc/wavefront.cu).

#pragma once

#include <assert.h>

#include "cull.cuh"

namespace l2n {

// The primary casts' visible spheres: indices in ascending order and, per
// entry, the origin terms rox, roy, roz and c of the sweep, computed from
// the camera position (ox, oy, oz) as the sweep computes them.
struct Primaries {
  const int32_t* index;
  const float *rox, *roy, *roz, *c;
  int n;
  float ox, oy, oz;
};

// Sphere SoA plus the per-sphere table: rows of a (13, n) buffer
// (SphereScene.packed()): centre, r^2, albedo, then the six material rows
// `mat` (read by the materials body and the bumped normal AOV only).
struct SceneView {
  const float *cx, *cy, *cz, *r2, *ar, *ag, *ab, *mat;
  int n;
  bool fast;      // fast_math: the nearest sweeps' sqrt and normal by rsqrt
  Primaries vis;  // vis.index null: the primary cast sweeps all spheres

  // The normal AOV's colour of a miss: black.
  L2N_HD static void miss_color(float col[3]) {
    col[0] = col[1] = col[2] = 0.0f;
  }

  // NEE samples a point on a light sphere's surface (pathtrace.cuh
  // nee_area); sphere i's centre and r^2.
  static constexpr bool kConeLights = false;
  L2N_HD void bound(int i, float& x, float& y, float& z, float& rr) const {
    x = cx[i];
    y = cy[i];
    z = cz[i];
    rr = r2[i];
  }

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const;
  L2N_HD Hit nearest_primary(float ox, float oy, float oz, float dx,
                             float dy, float dz) const;
  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const;
  L2N_HD bool occluded(float ox, float oy, float oz, float dx, float dy,
                       float dz) const;
  L2N_HD Hit resolve(float best, int bi, float ox, float oy, float oz,
                     float dx, float dy, float dz) const;
};

L2N_HD SceneView scene_view(const float* packed, int n, bool fast) {
  return SceneView{packed,         packed + n,     packed + 2 * n,
                   packed + 3 * n, packed + 4 * n, packed + 5 * n,
                   packed + 6 * n, packed + 7 * n, n,
                   fast,           Primaries{}};
}

// Fill the visible list's origin terms for entries first, first + step, ...
// (the kernel's threads split the list; the host passes 0 and 1).
L2N_HD void primary_terms(const PtParams& p, const SceneView& s,
                          const int32_t* index, int n_vis, float* rox,
                          float* roy, float* roz, float* c, int first,
                          int step) {
  const float* cam = camera_block(p);
  const float ox = cam[32], oy = cam[33], oz = cam[34];
  for (int j = first; j < n_vis; j += step) {
    const int i = index[j];
    const float x = ox - s.cx[i], y = oy - s.cy[i], z = oz - s.cz[i];
    rox[j] = x;
    roy[j] = y;
    roz[j] = z;
    c[j] = x * x + y * y + z * z - s.r2[i];
  }
}

// The threads of the warp that call together (one on the host), and
// whether any of them holds `pred`. A sweep skips a sphere's square root
// and roots when no lane's ray line meets it (every discriminant < 0, so
// every lane's t would be a miss): the same hit, for fewer instructions.
L2N_HD unsigned active_lanes() {
#if defined(__CUDA_ARCH__)
  return __activemask();
#else
  return 1u;
#endif
}

L2N_HD bool any_lane(unsigned lanes, bool pred) {
#if defined(__CUDA_ARCH__)
  return __any_sync(lanes, pred);
#else
  (void)lanes;
  return pred;
#endif
}

// One candidate of the half-b sweep: t >= 0, or kBig for a miss. A negative
// discriminant makes sqrtf NaN, and NaN fails every comparison. `fast`
// (fast_math) takes the root as disc * rsqrt(disc), which is NaN at
// disc == 0 too: a tangent ray misses, as in the JAX package. The sweeps'
// vote (disc >= 0) lets that candidate through to be poisoned here.
L2N_HD float sweep_t(float hb, float c, bool fast) {
  const float disc = hb * hb - c;
  const float sq = fast ? disc * rsqrt_fast(disc) : sqrtf(disc);
  const float nhb = -hb;
  const float t1 = nhb - sq;
  const float t2 = nhb + sq;
  const float t = t1 >= 0.0f ? t1 : t2;
  return t >= 0.0f ? t : kBig;
}

// The hit of the winner bi (-1: none) at distance best: its normal and r^2
// gathered from the SoA once.
L2N_HD Hit SceneView::resolve(float best, int bi, float ox, float oy,
                              float oz, float dx, float dy, float dz) const {
  const bool hit = best < kBig;
  const float bcx = bi >= 0 ? cx[bi] : 0.0f;
  const float bcy = bi >= 0 ? cy[bi] : 0.0f;
  const float bcz = bi >= 0 ? cz[bi] : 0.0f;
  Hit h;
  h.t = hit ? best : -1.0f;
  const float nx = ox + h.t * dx - bcx;
  const float ny = oy + h.t * dy - bcy;
  const float nz = oz + h.t * dz - bcz;
  const float rcp = hit ? rcp_len(nx * nx + ny * ny + nz * nz, fast) : 0.0f;
  h.nx = nx * rcp;
  h.ny = ny * rcp;
  h.nz = nz * rcp;
  h.index = bi;
  h.r2 = bi >= 0 ? r2[bi] : 1.0f;
  h.tc_u = h.tc_v = h.b_u = h.b_v = 0.0f;
  return h;
}

// The first index of the minimum t over all spheres.
L2N_HD Hit SceneView::nearest(float ox, float oy, float oz, float dx,
                              float dy, float dz) const {
  float best = kBig;
  int bi = -1;
  const unsigned lanes = active_lanes();
  for (int i = 0; i < n; ++i) {
    const float rox = ox - cx[i], roy = oy - cy[i], roz = oz - cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - r2[i];
    if (!any_lane(lanes, hb * hb - c >= 0.0f)) continue;
    const float t = sweep_t(hb, c, fast);
    if (t < best) {
      best = t;
      bi = i;
    }
  }
  return resolve(best, bi, ox, oy, oz, dx, dy, dz);
}

// The same hit for a primary ray (origin the camera): over the visible list
// in ascending index order with the hoisted origin terms, so the first index
// of the minimum t is the full sweep's. The terms ignore the origin passed;
// the host build (the CPU tests) asserts that it is the list's.
L2N_HD Hit SceneView::nearest_primary(float ox, float oy, float oz, float dx,
                                      float dy, float dz) const {
  if (vis.index == nullptr) return nearest(ox, oy, oz, dx, dy, dz);
#if !defined(__CUDA_ARCH__)
  assert(ox == vis.ox && oy == vis.oy && oz == vis.oz);
#endif
  float best = kBig;
  int bj = -1;
  const unsigned lanes = active_lanes();
  for (int j = 0; j < vis.n; ++j) {
    const float hb = vis.rox[j] * dx + vis.roy[j] * dy + vis.roz[j] * dz;
    if (!any_lane(lanes, hb * hb - vis.c[j] >= 0.0f)) continue;
    const float t = sweep_t(hb, vis.c[j], fast);
    if (t < best) {
      best = t;
      bj = j;
    }
  }
  return resolve(best, bj >= 0 ? vis.index[bj] : -1, ox, oy, oz, dx, dy, dz);
}

// The ambient-occlusion cast: the nearest-hit sweep, as the JAX package
// casts it (not the any-hit test, whose arithmetic differs).
L2N_HD bool SceneView::occluded(float ox, float oy, float oz, float dx,
                                float dy, float dz) const {
  return nearest(ox, oy, oz, dx, dy, dz).t >= 0.0f;
}

// Any sphere with t >= 0: origin inside (c < 0) or ahead with a real root.
L2N_HD bool SceneView::anyhit(float ox, float oy, float oz, float dx,
                              float dy, float dz) const {
  for (int i = 0; i < n; ++i) {
    const float rox = ox - cx[i], roy = oy - cy[i], roz = oz - cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - r2[i];
    if (c < 0.0f || (hb < 0.0f && hb * hb >= c)) return true;
  }
  return false;
}

#if defined(__CUDACC__)
// Let `kernel` launch with `bytes` of dynamic shared memory: above the
// default 48 KiB a kernel opts in, once per instantiation (`opted`, the
// caller's static record, so not again while a CUDA graph captures).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc == cudaSuccess) opted = bytes;
  return rc;
}

// Shared memory of stage_culled_scene over n spheres with `table` rows of
// the per-sphere table (3, the albedo, or 9, pathtrace.cuh table_rows), in
// floats: the first 4 + table rows of the (13, n) buffer, the visible list
// (n ints), its origin terms (4 rows of n) and kCullCounts ints for
// block_rank. The kernels stage a compile-time row count (kTable): as a
// runtime argument it cost the default path two registers and ~2% of its
// whole-frame time (PERF.md §6).
constexpr int kCullCounts = 33;
inline size_t culled_scene_floats(int n, int table) {
  return (4 + table + 5) * static_cast<size_t>(n) + kCullCounts;
}

// A block's prologue for the primaries of tile (tile_x, tile_y): stage the
// first 4 + kTable rows of the (13, n) scene into smem, build the tile's
// visible list and its origin terms; returns the scene with `vis` set (its
// `mat` rows valid only where kTable is 9). Every thread of the block must
// call it; it ends with a barrier.
template <int kTable>
__device__ inline SceneView stage_culled_scene(
    const PtParams& p, const float* __restrict__ spheres, float* smem,
    int tile_x, int tile_y) {
  const int n = p.n_scene;
  constexpr int rows = 4 + kTable;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x)
    smem[i] = spheres[i];
  int32_t* s_index = reinterpret_cast<int32_t*>(smem + rows * n);
  float* s_terms = smem + (rows + 1) * n;  // rox | roy | roz | c
  int32_t* s_counts = reinterpret_cast<int32_t*>(smem + (rows + 5) * n);
  __syncthreads();
  SceneView scene = scene_view(smem, n, p.fast_math != 0);
  const TileCone cone = tile_cone(p, tile_x, tile_y);
  const int n_vis = build_visible_block(
      p, cone,
      [&](int i, float& cx, float& cy, float& cz, float& r2) {
        cx = scene.cx[i];
        cy = scene.cy[i];
        cz = scene.cz[i];
        r2 = scene.r2[i];
      },
      n, s_index, s_counts);
  primary_terms(p, scene, s_index, n_vis, s_terms, s_terms + n,
                s_terms + 2 * n, s_terms + 3 * n,
                static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
  __syncthreads();
  const float* cam = camera_block(p);
  scene.vis = Primaries{s_index, s_terms, s_terms + n, s_terms + 2 * n,
                        s_terms + 3 * n, n_vis, cam[32], cam[33], cam[34]};
  return scene;
}
#endif

}  // namespace l2n
