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
//   rays (9 planes): cast origin, direction, throughput (Continuation);
//                    dead lanes have cast_ox = kFar;
//   col  (3 planes): pass A's partial radiance;
//   meta (2 planes): pixel index and sample index, as int32 bit patterns.
//
// The passes are templates on a counter-based sampler (ThreefrySampler, or
// PhiloxSampler for rng="tpu_hw"): pass B regenerates each path's stream
// from its meta planes and resumes it where pass A stopped.

#pragma once

#include "sphere_pt.cuh"

namespace l2n {

constexpr int kRayPlanes = 9;

L2N_HD size_t lane_count(const PtParams& p) {
  return static_cast<size_t>(p.k) * static_cast<size_t>(p.spp) *
         static_cast<size_t>(p.tile_height) * static_cast<size_t>(p.tile_width);
}

L2N_HD size_t lane_index(const PtParams& p, int k, int s, int r, int c) {
  return (static_cast<size_t>(k * p.spp + s) * p.tile_height + r) *
             static_cast<size_t>(p.tile_width) + c;
}

// Pass A for pixel (r, c) of scheduled tile k: per sample, the jittered
// primary ray, its first vertex (trace_primary) and the lane's planes.
template <class Rng, class Scene>
L2N_HD void wavefront_pass_a_pixel(const PtParams& p, const Scene& s, int k,
                                   int r, int c, const int32_t* sched,
                                   const float* accum, float* rays,
                                   float* col, int32_t* meta) {
  const int row = sched[2 * k + 1] * p.tile_height + r;
  const int column = sched[2 * k] * p.tile_width + c;
  const uint32_t pixel_index =
      static_cast<uint32_t>(column + row * p.padded_width);
  const uint32_t sample_index = static_cast<uint32_t>(static_cast<int32_t>(
      accum[3 * plane_size(p) + pixel_offset(p, row, column)]));
  const size_t n = lane_count(p);
  for (int si = 0; si < p.spp; ++si) {
    const uint32_t sample = sample_index + static_cast<uint32_t>(si);
    Rng rng = Rng::at(p, pixel_index, sample);
    float dx, dy, dz;
    primary_direction(p, rng, row, column, dx, dy, dz);
    float rgb[3];
    Continuation cont;
    trace_primary(p, s, rng, p.cam[32], p.cam[33], p.cam[34], dx, dy, dz,
                  rgb, cont);
    const size_t lane = lane_index(p, k, si, r, c);
    const float planes[kRayPlanes] = {cont.ox, cont.oy, cont.oz,
                                      cont.dx, cont.dy, cont.dz,
                                      cont.tp[0], cont.tp[1], cont.tp[2]};
    for (int i = 0; i < kRayPlanes; ++i) rays[i * n + lane] = planes[i];
    for (int ch = 0; ch < 3; ++ch) col[ch * n + lane] = rgb[ch];
    meta[lane] = static_cast<int32_t>(pixel_index);
    meta[n + lane] = static_cast<int32_t>(sample);
  }
}

// Pass B for compacted lane `lane` of n_lanes: resume the sample's stream
// at (next_pair, has_spare), finish the path (trace_continue) and write its
// contribution (3 planes of n_lanes).
template <class Rng, class Scene>
L2N_HD void wavefront_pass_b_lane(const PtParams& p, const Scene& s,
                                  int next_pair, bool has_spare, size_t lane,
                                  size_t n_lanes, const float* rays,
                                  const int32_t* meta, float* contrib) {
  Continuation cont;
  cont.ox = rays[lane];
  cont.oy = rays[n_lanes + lane];
  cont.oz = rays[2 * n_lanes + lane];
  cont.dx = rays[3 * n_lanes + lane];
  cont.dy = rays[4 * n_lanes + lane];
  cont.dz = rays[5 * n_lanes + lane];
  for (int i = 0; i < 3; ++i) cont.tp[i] = rays[(6 + i) * n_lanes + lane];
  Rng rng = Rng::resumed(p, static_cast<uint32_t>(meta[lane]),
                         static_cast<uint32_t>(meta[n_lanes + lane]), next_pair,
                         has_spare);
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  trace_continue(p, s, rng, cont, rgb);
  for (int ch = 0; ch < 3; ++ch) contrib[ch * n_lanes + lane] = rgb[ch];
}

// Pass C for pixel (r, c) of scheduled tile k: per sample, sum + colA +
// contrib in that order (one of the two is 0, so the sum is the fused
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
