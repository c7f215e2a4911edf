// Per-tile cone culling of primary rays, shared by the sphere and triangle
// kernels (csrc/sphere_pt.cu, csrc/triangle_pt.cu): the counterpart of the
// JAX package's l2n_tpu/ops/kernels/sphere_pt.py::visibility_table, which
// its triangle kernel also runs over the mesh bounding spheres.
//
// Every primary ray of a tile starts at the camera and points through a
// jittered pixel of the tile, so it lies inside the cone spanned by the
// tile's corner rays. A sphere (or bound sphere) can be hit by a primary
// only if it meets that cone. The test is the JAX table's, operation for
// operation in float32: corner and centre rays through generate_rays with
// zero jitter (the configured camera form and normalization, as the
// primaries), the cone's cosine relaxed by 5% of 1 - cos
// plus 1e-4, and always kept when the camera lies inside the sphere
// (d2 <= r2). It only ever keeps too many, so a sweep over the kept
// spheres in ascending index order finds the full sweep's winner: a culled
// sphere's t is always a miss.
//
// `__host__ __device__` like the path body: the CPU tests build it with g++
// and hold it against the plain torch table (ops/kernels/sphere_pt.py::
// visibility_table). The kernels compact the list with a warp ballot and a
// block prefix (build_visible_block); the host builds it serially
// (build_visible_serial) with the same per-sphere test.

#pragma once

#include "pathtrace.cuh"

namespace l2n {

// A tile's view cone: its axis (the centre ray) and the relaxed cosine and
// sine of its half-angle.
struct TileCone {
  float ax, ay, az, cos_safe, sin_safe;
};

// The tile (tile_x, tile_y) of the frame's planes: its rows are global rows
// from p.row_offset on, as render_pixel's (JAX: visibility_table's
// row_offset).
L2N_HD TileCone tile_cone(const PtParams& p, int tile_x, int tile_y) {
  const float x0 = static_cast<float>(tile_x) * static_cast<float>(p.tile_width);
  const float y0 =
      static_cast<float>(tile_y) * static_cast<float>(p.tile_height) +
      static_cast<float>(p.row_offset);
  const float x1 = x0 + static_cast<float>(p.tile_width);
  const float y1 = y0 + static_cast<float>(p.tile_height);
  TileCone k;
  camera_direction(p, 0.5f * (x0 + x1), 0.5f * (y0 + y1), 0.0f, 0.0f, k.ax,
                   k.ay, k.az);
  float cos_min = 1.0f;
  const float xs[4] = {x0, x1, x0, x1};
  const float ys[4] = {y0, y0, y1, y1};
  for (int i = 0; i < 4; ++i) {
    float dx, dy, dz;
    camera_direction(p, xs[i], ys[i], 0.0f, 0.0f, dx, dy, dz);
    const float c = dx * k.ax + dy * k.ay + dz * k.az;
    cos_min = c < cos_min ? c : cos_min;
  }
  k.cos_safe = cos_min - 0.05f * (1.0f - cos_min) - 1e-4f;
  const float s2 = 1.0f - k.cos_safe * k.cos_safe;
  k.sin_safe = sqrtf(s2 > 0.0f ? s2 : 0.0f);
  return k;
}

// Does the sphere (cx, cy, cz, r2) meet the cone from the camera position
// (cam[32..34])?
L2N_HD bool cone_keeps(const PtParams& p, const TileCone& k, float cx,
                       float cy, float cz, float r2) {
  const float vx = cx - p.cam[32], vy = cy - p.cam[33], vz = cz - p.cam[34];
  const float d2 = vx * vx + vy * vy + vz * vz;
  const float dlen = sqrtf(d2 > 1e-20f ? d2 : 1e-20f);
  const float cos_phi = (vx * k.ax + vy * k.ay + vz * k.az) / dlen;
  const float sa = sqrtf(r2) / dlen;
  const float sin_a = sa < 1.0f ? sa : 1.0f;
  const float ca2 = 1.0f - sin_a * sin_a;
  const float cos_a = sqrtf(ca2 > 0.0f ? ca2 : 0.0f);
  return d2 <= r2 || cos_phi >= k.cos_safe * cos_a - k.sin_safe * sin_a;
}

// The visible list of a tile over n spheres, `sphere(i, cx, cy, cz, r2)`
// reading sphere i, in ascending index order, built serially; returns its
// length.
template <class Sphere>
L2N_HD int build_visible_serial(const PtParams& p, const TileCone& k,
                                Sphere sphere, int n, int32_t* vis) {
  int count = 0;
  for (int i = 0; i < n; ++i) {
    float cx, cy, cz, r2;
    sphere(i, cx, cy, cz, r2);
    if (cone_keeps(p, k, cx, cy, cz, r2)) vis[count++] = i;
  }
  return count;
}

#if defined(__CUDACC__)
// The rank of this thread's `flag` among the set flags of its block, in
// thread order, and their number in `total`: a warp ballot and a prefix
// over the block's warps. `counts` is 33 ints of shared memory. Every
// thread of the block must call it; it ends with a barrier after which
// `counts` is read, so the caller syncs before reusing it.
__device__ __forceinline__ int block_rank(bool flag, int32_t* counts,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  const int live = blockDim.x - 32 * warp;  // the warp's threads
  const unsigned mask = live >= 32 ? 0xFFFFFFFFu : (1u << live) - 1u;
  const unsigned ballot = __ballot_sync(mask, flag);
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = counts[w];
      counts[w] = run;
      run += c;
    }
    counts[32] = run;
  }
  __syncthreads();
  total = counts[32];
  return counts[warp] + __popc(ballot & ((1u << lane) - 1u));
}

// The same list built by the whole block into shared memory: each thread
// tests spheres threadIdx.x, threadIdx.x + blockDim.x, ..., and block_rank
// gives each kept sphere its slot. `warp_counts` is 33 ints of shared
// memory; every thread gets the length. Ends with a barrier, so the list
// is ready on return. Every thread of the block must call it.
template <class Sphere>
__device__ int build_visible_block(const PtParams& p, const TileCone& k,
                                   Sphere sphere, int n, int32_t* vis,
                                   int32_t* warp_counts) {
  int total = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, r2 = 0.0f;
    if (i < n) sphere(i, cx, cy, cz, r2);
    const bool keep = i < n && cone_keeps(p, k, cx, cy, cz, r2);
    int kept;
    const int slot = block_rank(keep, warp_counts, kept);
    if (keep) vis[total + slot] = i;
    total += kept;
    __syncthreads();
  }
  return total;
}
#endif

}  // namespace l2n
