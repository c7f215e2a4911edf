// Per-lane bodies of the wavefront sphere step's three passes (csrc/
// wavefront.cu), on the shared path body (csrc/pathtrace.cuh) and the
// sphere scene (csrc/sphere_pt.cuh).
//
// `__host__ __device__` like the path body: the CPU tests build this header
// with g++ against the plain passes (ops/kernels/wavefront.py).
//
// Lane layout, the JAX package's: a lane array is (planes, K, spp *
// tile_height, tile_width), so lane ((k * spp + s) * tile_height + r) *
// tile_width + c is sample s of pixel (r, c) of scheduled tile k, and plane
// i of lane l sits at i * n_lanes + l.
//   col  (3 planes): pass A's partial radiance;
//   back (3 planes): the rest of the path's radiance: 0 where the path ended
//                    in pass A (pass A writes it), pass B's contribution
//                    where it went on (pass B writes it; under NEE the
//                    whole path's, pass B zeroing col there).
// Slot layout: pass A appends each survivor to slot 0, 1, ... of arrays of
// n_lanes slots; slots 0 .. n_alive - 1 hold the survivors, in lane order
// within a warp's append and in no fixed order between warps.
//   rays (9 planes, 10 under NEE with MIS): cast origin, direction,
//                    throughput and, under MIS, the direction's pdf
//                    (Continuation; ray_planes);
//   meta (3 planes): pixel index, sample index (as int32 bit patterns) and
//                    the lane the survivor came from.
// The image does not depend on the slot order: pass B's work on a survivor
// depends only on its planes and its counter-based stream, keyed by pixel
// and sample, and writes to its own lane; pass C sums by lane.
//
// Passes A and B are templates on a counter-based sampler (ThreefrySampler,
// or PhiloxSampler for rng="tpu_hw"): pass B regenerates each path's
// stream from its meta planes and resumes it where pass A stopped, which
// depends on the material mode and NEE (ops/pathtrace.py::
// wavefront_draw_position). kBody is the path tracer's body (pathtrace.cuh
// path_body): Lambert, materials (the material modes and the bump; the
// split takes no explicit lights, as in the JAX package) or NEE, which
// does NEE at pass A's first vertex and carries its MIS pdf to pass B in
// the 10th ray plane.

#pragma once

#include "sphere_pt.cuh"

namespace l2n {

constexpr int kRayPlanes = 9;
constexpr int kMetaPlanes = 3;

// The ray planes of a step: 9, and the pdf plane under NEE with MIS (ops/
// kernels/wavefront.py::ray_planes).
L2N_HD int ray_planes(const PtParams& p) {
  return p.nee && p.mis ? kRayPlanes + 1 : kRayPlanes;
}

L2N_HD size_t lane_count(const PtParams& p) {
  return static_cast<size_t>(p.k) * static_cast<size_t>(p.spp) *
         static_cast<size_t>(p.tile_height) * static_cast<size_t>(p.tile_width);
}

L2N_HD size_t lane_index(const PtParams& p, int k, int s, int r, int c) {
  return (static_cast<size_t>(k * p.spp + s) * p.tile_height + r) *
             static_cast<size_t>(p.tile_width) + c;
}

// Pass A's outputs: col and back by lane, rays and meta by slot.
struct PassALanes {
  float* col;
  float* back;
  float* rays;
  int32_t* meta;
};

// Pass A for sample si of pixel (r, c) of scheduled tile k: the jittered
// primary ray, its first vertex (trace_primary), col at the lane, and
// either back = 0 at the lane or the survivor's planes at the slot that
// `append(alive)` returns. The kernel's append is warp-collective, so every
// thread calls it once per sample, alive or not; the host's is serial.
template <class Rng, int kBody, class Scene, class Append>
L2N_HD void wavefront_pass_a_sample(const PtParams& p, const Scene& s, int k,
                                    int si, int r, int c,
                                    const int32_t* sched, const float* accum,
                                    const PassALanes& out, Append& append) {
  // The frame's own row: the wrappers refuse a slab (p.row_offset and
  // p.stream are 0 here; ops/kernels/wavefront.py).
  const int row = sched[2 * k + 1] * p.tile_height + r;
  const int column = sched[2 * k] * p.tile_width + c;
  const uint32_t pixel_index =
      static_cast<uint32_t>(column + row * p.padded_width);
  const uint32_t sample =
      static_cast<uint32_t>(static_cast<int32_t>(
          accum[3 * plane_size(p) + pixel_offset(p, row, column)])) +
      static_cast<uint32_t>(si);
  Rng rng = Rng::at(p, pixel_index, sample);
  float dx, dy, dz;
  primary_direction(p, rng, row, column, dx, dy, dz);
  float rgb[3];
  Continuation cont;
  const bool alive = trace_primary<kBody>(
      p, s, rng, p.cam[32], p.cam[33], p.cam[34], dx, dy, dz, rgb, cont);
  const size_t n = lane_count(p);
  const size_t lane = lane_index(p, k, si, r, c);
  for (int ch = 0; ch < 3; ++ch) out.col[ch * n + lane] = rgb[ch];
  const int slot = append(alive);
  if (!alive) {
    for (int ch = 0; ch < 3; ++ch) out.back[ch * n + lane] = 0.0f;
    return;
  }
  const float planes[kRayPlanes] = {cont.ox, cont.oy, cont.oz,
                                    cont.dx, cont.dy, cont.dz,
                                    cont.tp[0], cont.tp[1], cont.tp[2]};
  for (int i = 0; i < kRayPlanes; ++i) out.rays[i * n + slot] = planes[i];
  if constexpr (kBody == kBodyNee)
    if (p.mis) out.rays[kRayPlanes * n + slot] = cont.pdf;
  out.meta[slot] = static_cast<int32_t>(pixel_index);
  out.meta[n + slot] = static_cast<int32_t>(sample);
  out.meta[2 * n + slot] = static_cast<int32_t>(lane);
}

// Pass B's group of lanes per ray: 8 when every survivor still gets its
// own group of 8 among `threads` threads, else 1 (measured: 8 at the
// reference's 10 tiles, 1 at whole frame, PERF.md).
constexpr int kMaxGroup = 8;

L2N_HD int group_size(long long alive, long long threads) {
  return alive * kMaxGroup <= threads ? kMaxGroup : 1;
}

// A sphere's centre and r^2 in one 16-byte word: pass B's sweeps read one
// shared-memory load per sphere instead of four.
struct alignas(16) Sphere4 {
  float cx, cy, cz, r2;
};

// Pass B's sphere scene: the SoA (albedo, and the winner's centre and r^2
// for the hit) and the packed copy its sweeps read, with each ray's sweeps
// split across a group of G lanes of a warp. Lane g of the group sweeps
// spheres g, g + G, ... in ascending order with SceneView::nearest's
// operations; the group then keeps the smaller t and, on a tie, the
// smaller index, which is the full sweep's first index of the minimum t:
// the same hit, to the bit. Any-hit is the group's OR. Every lane of the
// group traces the same ray, so the rest of the path runs redundantly and
// identically on each. The host build (the CPU tests) runs the G parts one
// after another and combines them the same way.
template <int G>
struct GroupScene : SceneView {
  const Sphere4* packed;
  int g;          // this lane's part
  unsigned mask;  // the group's lanes in the warp

  L2N_HD static void combine(float& best, int& bi, float ot, int oi) {
    if (ot < best || (ot == best && oi < bi)) {
      best = ot;
      bi = oi;
    }
  }

  // Part `part` of the sweep: spheres part, part + G, ... in ascending
  // order. Every lane runs the same ceil(n / G) rounds, a lane past the
  // last sphere voting no, so that the warp's votes and the group's
  // shuffles after the sweep stay matched when G does not divide n.
  L2N_HD void sweep_part(int part, float ox, float oy, float oz, float dx,
                         float dy, float dz, float& best, int& bi) const {
    const unsigned lanes = active_lanes();
    for (int base = 0; base < n; base += G) {
      const int i = base + part;
      const bool in = i < n;
      const Sphere4 q = packed[in ? i : 0];
      const float rox = ox - q.cx, roy = oy - q.cy, roz = oz - q.cz;
      const float hb = rox * dx + roy * dy + roz * dz;
      const float c = rox * rox + roy * roy + roz * roz - q.r2;
      if (!any_lane(lanes, in && hb * hb - c >= 0.0f) || !in) continue;
      const float t = sweep_t(hb, c, fast);
      if (t < best) {
        best = t;
        bi = i;
      }
    }
  }

  L2N_HD bool anyhit_part(int part, float ox, float oy, float oz, float dx,
                          float dy, float dz) const {
    for (int i = part; i < n; i += G) {
      const Sphere4 q = packed[i];
      const float rox = ox - q.cx, roy = oy - q.cy, roz = oz - q.cz;
      const float hb = rox * dx + roy * dy + roz * dz;
      const float c = rox * rox + roy * roy + roz * roz - q.r2;
      if (c < 0.0f || (hb < 0.0f && hb * hb >= c)) return true;
    }
    return false;
  }

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    float best = kBig;
    int bi = -1;
#if defined(__CUDA_ARCH__)
    sweep_part(g, ox, oy, oz, dx, dy, dz, best, bi);
    for (int off = 1; off < G; off <<= 1)
      combine(best, bi, __shfl_xor_sync(mask, best, off),
              __shfl_xor_sync(mask, bi, off));
#else
    for (int part = 0; part < G; ++part) {
      float pt = kBig;
      int pi = -1;
      sweep_part(part, ox, oy, oz, dx, dy, dz, pt, pi);
      combine(best, bi, pt, pi);
    }
#endif
    return resolve(best, bi, ox, oy, oz, dx, dy, dz);
  }

  L2N_HD Hit nearest_primary(float ox, float oy, float oz, float dx,
                             float dy, float dz) const {
    return nearest(ox, oy, oz, dx, dy, dz);
  }

  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
#if defined(__CUDA_ARCH__)
    const bool hit = anyhit_part(g, ox, oy, oz, dx, dy, dz);
    return G == 1 ? hit : __any_sync(mask, hit);
#else
    bool hit = false;
    for (int part = 0; part < G; ++part)
      hit = anyhit_part(part, ox, oy, oz, dx, dy, dz) || hit;
    return hit;
#endif
  }
};

// Pass B for slot `slot` of n_lanes: resume the sample's stream at
// (next_pair, has_spare), finish the path (trace_continue) and, if `write`,
// write its contribution to back at the survivor's lane. The NEE body's
// pass A added the first vertex's direct light to the lane's col: the path
// goes on from that sum, as the fused kernel's does, back gets the whole
// path's radiance and col 0 (read before the path's first sweep, whose
// shuffles order it before the group's write), so pass C's sum is the
// fused kernel's to the bit. The other bodies leave col alone (0 at a
// survivor's lane).
template <class Rng, int kBody, class Scene>
L2N_HD void wavefront_pass_b_slot(const PtParams& p, const Scene& s,
                                  int next_pair, bool has_spare, size_t slot,
                                  size_t n_lanes, const float* rays,
                                  const int32_t* meta, float* col,
                                  float* back, bool write) {
  Continuation cont;
  cont.ox = rays[slot];
  cont.oy = rays[n_lanes + slot];
  cont.oz = rays[2 * n_lanes + slot];
  cont.dx = rays[3 * n_lanes + slot];
  cont.dy = rays[4 * n_lanes + slot];
  cont.dz = rays[5 * n_lanes + slot];
  for (int i = 0; i < 3; ++i) cont.tp[i] = rays[(6 + i) * n_lanes + slot];
  cont.pdf = 1.0f;
  if constexpr (kBody == kBodyNee)
    if (p.mis) cont.pdf = rays[kRayPlanes * n_lanes + slot];
  Rng rng = Rng::resumed(p, static_cast<uint32_t>(meta[slot]),
                         static_cast<uint32_t>(meta[n_lanes + slot]),
                         next_pair, has_spare);
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kBody == kBodyNee) {
    const size_t lane = static_cast<size_t>(meta[2 * n_lanes + slot]);
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = col[ch * n_lanes + lane];
  }
  trace_continue<kBody>(p, s, rng, cont, rgb);
  if (!write) return;
  const size_t lane = static_cast<size_t>(meta[2 * n_lanes + slot]);
  for (int ch = 0; ch < 3; ++ch) back[ch * n_lanes + lane] = rgb[ch];
  if constexpr (kBody == kBodyNee)
    for (int ch = 0; ch < 3; ++ch) col[ch * n_lanes + lane] = 0.0f;
}

// Pass C for pixel (r, c) of scheduled tile k: per sample, sum + colA +
// back in that order (one of the two is 0, so the sum is the fused
// kernel's sum + c to the bit), then accumulate and tonemap in place.
L2N_HD void wavefront_pass_c_pixel(const PtParams& p, int k, int r, int c,
                                   const int32_t* sched, const float* col,
                                   const float* back, float* accum,
                                   float* output) {
  const size_t n = lane_count(p);
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int si = 0; si < p.spp; ++si) {
    const size_t lane = lane_index(p, k, si, r, c);
    for (int ch = 0; ch < 3; ++ch)
      sum[ch] = sum[ch] + col[ch * n + lane] + back[ch * n + lane];
  }
  accumulate_pixel(p, sched[2 * k + 1] * p.tile_height + r,
                   sched[2 * k] * p.tile_width + c, sum, accum, output);
}

}  // namespace l2n
