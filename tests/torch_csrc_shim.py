"""The host build of the CUDA kernels' headers for the CPU tests: the
C++ shim over `l2n_tpu_torch/csrc/*.cuh`, built with g++ into a small
ctypes library (and with AddressSanitizer), its pytest fixtures and the
pointer and parameter helpers that the tests/test_torch_csrc*.py and
tests/test_torch_shellwalk.py files share. It imports nothing of the port
when it is imported (tests/test_aot_cache.py scans the loaded `l2n_tpu*`
modules).

The shim's step entry points take the kernels' parameter arrays, the
float array followed by the 40 floats of the packed camera (`host_params`),
and hand the headers that camera block (PtParams::cam, which the host
build reads where the card reads its constant copy).
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "l2n_tpu_torch" / "csrc"

SHIM = r"""
#include <cmath>
#include <cstdint>
#include <vector>
// Each walk's scans: how many, how many overflowed the per-lane list, and
// the longest list (the kernels define no hook).
static int64_t g_scans = 0, g_overflows = 0, g_longest = 0;
#define L2N_NOTE_SCAN(cnt, more) \
  (++g_scans, g_overflows += (more), \
   g_longest = (cnt) > g_longest ? (cnt) : g_longest)
// The casts whose seeded walk fell short of its seed and walked again.
static int64_t g_fallbacks = 0;
#define L2N_NOTE_FALLBACK() (++g_fallbacks)
// The seed that the last seeded walk's first scan took.
static float g_seed = 0.0f;
#define L2N_NOTE_SEED(best) (g_seed = (best))
// The shell visits (csrc/shellwalk.cuh) by kind (miss, window, wide) and
// the windows that walked the slabs too; while g_shell_log is set, each
// visit as (ray, mesh, kind, i0, ni, j0, nj) and t_lim, and each window
// that walked the slabs as (ray, mesh, 3, 0, 0, 0, 0) and 0.
static int64_t g_shell[4] = {0, 0, 0, 0};
static bool g_shell_log = false;
static int32_t g_ray = 0;
static std::vector<int32_t> g_shell_rec;
static std::vector<float> g_shell_lim;
#define L2N_NOTE_SHELL(m, kind, w)                                         \
  (++g_shell[(kind)],                                                      \
   g_shell_log ? (g_shell_rec.insert(g_shell_rec.end(),                   \
                                     {g_ray, (m), (kind), (w).i0, (w).ni, \
                                      (w).j0, (w).nj}),                   \
                  g_shell_lim.push_back((w).t_lim))                       \
               : (void)0)
#define L2N_NOTE_SHELL_SLABS(m)                                            \
  (++g_shell[3],                                                           \
   g_shell_log ? (g_shell_rec.insert(g_shell_rec.end(),                   \
                                     {g_ray, (m), 3, 0, 0, 0, 0}),        \
                  g_shell_lim.push_back(0.0f))                            \
               : (void)0)
#include "sphere_pt.cuh"
#include "sweep_probe.cuh"
#include "triangle_pt.cuh"
#include "wavefront.cuh"

// A scheduled tile's view of the scene, as the kernels' prologue builds it:
// the cone-visible list of its primaries (serially, with the kernels' test)
// and, for spheres, the list's origin terms.
struct TileLists {
  std::vector<int32_t> index;
  std::vector<float> terms;
};

l2n::SceneView for_tile(const l2n::PtParams& p, l2n::SceneView s, int tx,
                        int ty, TileLists& lists) {
  const int n = s.n;
  lists.index.assign(n, -1);
  lists.terms.assign(4 * static_cast<size_t>(n), 0.0f);
  const int nv = l2n::build_visible_serial(
      p, l2n::tile_cone(p, tx, ty),
      [&](int i, float& cx, float& cy, float& cz, float& r2) {
        cx = s.cx[i];
        cy = s.cy[i];
        cz = s.cz[i];
        r2 = s.r2[i];
      },
      n, lists.index.data());
  float* t = lists.terms.data();
  l2n::primary_terms(p, s, lists.index.data(), nv, t, t + n, t + 2 * n,
                     t + 3 * n, 0, 1);
  s.vis = l2n::Primaries{lists.index.data(), t, t + n, t + 2 * n, t + 3 * n,
                         nv, p.cam[32], p.cam[33], p.cam[34]};
  return s;
}

l2n::TriSceneView for_tile(const l2n::PtParams& p, l2n::TriSceneView s,
                             int tx, int ty, TileLists& lists) {
  lists.index.assign(s.n, -1);
  const float* b = s.mesh_bounds;
  s.n_vis = l2n::build_visible_serial(
      p, l2n::tile_cone(p, tx, ty),
      [&](int i, float& cx, float& cy, float& cz, float& r2) {
        cx = b[4 * i];
        cy = b[4 * i + 1];
        cz = b[4 * i + 2];
        r2 = b[4 * i + 3];
      },
      s.n, lists.index.data());
  s.vis = lists.index.data();
  return s;
}

// The kernels' per-thread bodies over every pixel of the scheduled tiles,
// with the sampler and AOV instantiation the codes pick (as the entry
// points).
struct RenderTiles {
  template <class Rng, int kBody, bool kFast, bool kViewproj, class Scene>
  static int run(l2n::PtParams params, Scene s, const int32_t* sched,
                 float* accum, float* output, uint32_t* rng_state) {
    const l2n::PtParams p =
        l2n::body_options<kBody, kFast, kViewproj>(params);
    TileLists lists;
    for (int k = 0; k < p.k; ++k) {
      const Scene ts = for_tile(p, s, sched[2 * k], sched[2 * k + 1], lists);
      for (int r = 0; r < p.tile_height; ++r)
        for (int c = 0; c < p.tile_width; ++c)
          l2n::render_pixel<Rng, kBody>(
              p, ts, sched[2 * k + 1] * p.tile_height + r,
              sched[2 * k] * p.tile_width + c, accum, output, rng_state);
    }
    return 0;
  }
};

// Pass A's append, serial: over the lanes in lane order it gives the
// stable order of the plain compaction.
struct SerialAppend {
  int32_t* n_alive;
  int operator()(bool alive) { return alive ? (*n_alive)++ : -1; }
};

// F::template run<Rng, kBody> for the counter-based sampler and the path
// body (pathtrace.cuh path_body) of p: the passes' instantiations.
template <class F, class... Args>
int dispatch_pass(const l2n::PtParams& p, Args... args) {
  switch (l2n::path_body(p)) {
    case l2n::kBodyNee:
      return l2n::dispatch_counter_rng<l2n::WithBody<F, l2n::kBodyNee>>(
          p.rng, args...);
    case l2n::kBodyMaterials:
      return l2n::dispatch_counter_rng<
          l2n::WithBody<F, l2n::kBodyMaterials>>(p.rng, args...);
  }
  return l2n::dispatch_counter_rng<l2n::WithBody<F, l2n::kBodyLambert>>(
      p.rng, args...);
}

struct PassA {
  template <class Rng, int kBody>
  static int run(l2n::PtParams p, const int32_t* sched, const float* spheres,
                 const float* accum, l2n::PassALanes out, int32_t* n_alive) {
    const l2n::SceneView s =
        l2n::scene_view(spheres, p.n_scene, p.fast_math != 0);
    TileLists lists;
    *n_alive = 0;
    SerialAppend append{n_alive};
    for (int k = 0; k < p.k; ++k) {
      const l2n::SceneView ts = for_tile(p, s, sched[2 * k], sched[2 * k + 1],
                                         lists);
      for (int si = 0; si < p.spp; ++si)
        for (int r = 0; r < p.tile_height; ++r)
          for (int c = 0; c < p.tile_width; ++c)
            l2n::wavefront_pass_a_sample<Rng, kBody>(
                p, ts, k, si, r, c, sched, accum, out, append);
    }
    return 0;
  }
};

// Pass B over the first n_alive slots, each ray's sweeps split into
// `group` parts as a group of lanes of the kernel splits them, over the
// packed spheres the kernel stages.
struct PassB {
  template <class Rng, int kBody, int G>
  static void slots(const l2n::PtParams& p, const l2n::SceneView& s,
                    int next_pair, int has_spare, const int32_t* n_alive,
                    const float* rays, const int32_t* meta, float* col,
                    float* back) {
    std::vector<l2n::Sphere4> packed(s.n);
    for (int i = 0; i < s.n; ++i)
      packed[i] = l2n::Sphere4{s.cx[i], s.cy[i], s.cz[i], s.r2[i]};
    const l2n::GroupScene<G> gs{s, packed.data(), 0, 0u};
    for (size_t slot = 0; slot < static_cast<size_t>(n_alive[0]); ++slot)
      l2n::wavefront_pass_b_slot<Rng, kBody>(
          p, gs, next_pair, has_spare != 0, slot, l2n::lane_count(p), rays,
          meta, col, back, true);
  }
  template <class Rng, int kBody>
  static int run(l2n::PtParams p, int group, int next_pair, int has_spare,
                 const int32_t* n_alive, const float* spheres,
                 const float* rays, const int32_t* meta, float* col,
                 float* back) {
    const l2n::SceneView s =
        l2n::scene_view(spheres, p.n_scene, p.fast_math != 0);
    switch (group) {
      case 1:
        slots<Rng, kBody, 1>(p, s, next_pair, has_spare, n_alive, rays,
                             meta, col, back);
        return 0;
      case l2n::kMaxGroup:
        slots<Rng, kBody, l2n::kMaxGroup>(p, s, next_pair, has_spare,
                                          n_alive, rays, meta, col, back);
        return 0;
    }
    return -2;
  }
};

// The kernels' split sweep (csrc/onehot_recovery.cu) with G = `group`
// lanes per ray: the spheres packed into a buffer of exactly n records, as
// the block prologue stages them, then each lane's G parts combined.
template <bool kCarry, int G>
void onehot_split_lanes(const float* rays, const l2n_probe::Sphere4* s,
                        int n, const float* table, int64_t lanes,
                        float* out) {
  for (int64_t p = 0; p < lanes; ++p) {
    const float* r = rays + p;
    l2n_probe::Winner w = l2n_probe::split_sweep<kCarry, G>(
        s, n, 0, 0u, r[0], r[lanes], r[2 * lanes], r[3 * lanes],
        r[4 * lanes], r[5 * lanes], 1.0f);
    if (!kCarry) l2n_probe::gather_row(table, w);
    const float v[6] = {w.t, static_cast<float>(w.i), w.cx, w.cy, w.cz,
                        w.r2};
    for (int k = 0; k < 6; ++k) out[k * lanes + p] = v[k];
  }
}
template <int G>
void onehot_split_group(int carry, const float* rays,
                        const l2n_probe::Sphere4* s, int n,
                        const float* table, int64_t lanes, float* out) {
  if (carry)
    onehot_split_lanes<true, G>(rays, s, n, table, lanes, out);
  else
    onehot_split_lanes<false, G>(rays, s, n, table, lanes, out);
}

// sweep_variants' chunked lane body (csrc/sweep_variants.cu) with R repeats
// a chunk, over the spheres packed into a buffer of exactly n records, as
// the kernels' block prologue stages them.
template <int R>
void sweep_chunked_lanes(int carry, const float* o, const float* d,
                         const l2n_probe::Sphere4* s, int n, int64_t lanes,
                         int repeats, const float* bias, float* out) {
  for (int64_t p = 0; p < lanes; ++p) {
    const float* a = o + p;
    const float* b = d + p;
    out[p] = carry ? l2n_probe::sweep_lane_chunked<true, R>(
                         s, n, repeats, a[0], a[lanes], a[2 * lanes], b[0],
                         b[lanes], b[2 * lanes], bias[p])
                   : l2n_probe::sweep_lane_chunked<false, R>(
                         s, n, repeats, a[0], a[lanes], a[2 * lanes], b[0],
                         b[lanes], b[2 * lanes], bias[p]);
  }
}

// The tensor cores' sum of C and k exact products, emulated in one of the
// orders and roundings an mma.sync may use: 0 in slot order, 1 reversed,
// 2 pairwise, 3 in slot order truncating every sum, 4 every term aligned
// to the largest and truncated to its 24 bits, summed exactly, the result
// truncated.
static float to_float_rz(double s) {
  float f = static_cast<float>(s);
  if (std::fabs(static_cast<double>(f)) > std::fabs(s))
    f = std::nextafter(f, 0.0f);
  return f;
}
static float add_rz(float a, float b) {
  return to_float_rz(static_cast<double>(a) + b);
}
static float emulated_sum(int mode, float c, const float* p, int k) {
  float t[16];
  t[0] = c;
  for (int i = 0; i < k; ++i) t[1 + i] = p[i];
  int m = k + 1;
  float s = 0.0f;
  switch (mode) {
    case 0:
      s = t[0];
      for (int i = 1; i < m; ++i) s = s + t[i];
      return s;
    case 1:
      s = t[m - 1];
      for (int i = m - 2; i >= 0; --i) s = s + t[i];
      return s;
    case 2:
      while (m > 1) {
        for (int i = 0; i < m / 2; ++i) t[i] = t[2 * i] + t[2 * i + 1];
        if (m & 1) t[m / 2] = t[m - 1];
        m = (m + 1) / 2;
      }
      return t[0];
    case 3:
      s = t[0];
      for (int i = 1; i < m; ++i) s = add_rz(s, t[i]);
      return s;
    default: {
      int e = -1000;
      for (int i = 0; i < m; ++i)
        if (t[i] != 0.0f) {
          int ei;
          std::frexp(t[i], &ei);
          e = ei > e ? ei : e;
        }
      if (e == -1000) return 0.0f;
      const double q = std::ldexp(1.0, e - 24);
      double sum = 0.0;
      for (int i = 0; i < m; ++i) sum += std::trunc(t[i] / q) * q;
      return to_float_rz(sum);
    }
  }
}

// NEE at n lanes with the draws given (u (3, n): u_pick, ul1, ul2), at
// vertices h with shading normals nv (3, n), albedo kd and throughput tp
// (3, n), adding to col (3, n): the BSDF Lambert's (mode 0) or the material
// mode's around the unit normals nu with view directions wo and (6, n)
// material rows; with fog's transmittance where p.fog (the fog body's).
template <class Scene>
void nee_lanes(const l2n::PtParams& p, const Scene& s, int mode, int mis,
               const float* u, const float* h, const float* nv,
               const float* nu, const float* wo, const float* kd,
               const float* mat, const float* tp, int64_t n, float* col) {
  for (int64_t i = 0; i < n; ++i) {
    const float hi[3] = {h[i], h[n + i], h[2 * n + i]};
    const float ni[3] = {nv[i], nv[n + i], nv[2 * n + i]};
    const float ui[3] = {nu[i], nu[n + i], nu[2 * n + i]};
    const float oi[3] = {wo[i], wo[n + i], wo[2 * n + i]};
    const float k[3] = {kd[i], kd[n + i], kd[2 * n + i]};
    const float t[3] = {tp[i], tp[n + i], tp[2 * n + i]};
    const l2n::Material m = l2n::material_row(mat, static_cast<int>(n),
                                              static_cast<int>(i));
    float c[3] = {col[i], col[n + i], col[2 * n + i]};
    auto eval = [&](const float* l, float cos_s, float* f) {
      if (mode == 0) {
        for (int ch = 0; ch < 3; ++ch) f[ch] = k[ch] * l2n::kInvPi;
        return cos_s * l2n::kInvPi;
      }
      return l2n::eval_material(mode, ui, oi, l, k, m, f);
    };
    if constexpr (Scene::kConeLights) {
      if (p.fog)
        l2n::nee_cone<true>(p, s, u[i], u[n + i], u[2 * n + i], hi, ni,
                            mis != 0, eval, t, c);
      else
        l2n::nee_cone<false>(p, s, u[i], u[n + i], u[2 * n + i], hi, ni,
                             mis != 0, eval, t, c);
    } else {
      if (p.fog)
        l2n::nee_area<true>(p, s, u[i], u[n + i], u[2 * n + i], hi, ni,
                            mis != 0, eval, t, c);
      else
        l2n::nee_area<false>(p, s, u[i], u[n + i], u[2 * n + i], hi, ni,
                             mis != 0, eval, t, c);
    }
    for (int ch = 0; ch < 3; ++ch) col[ch * n + i] = c[ch];
  }
}
extern "C" {
int l2n_sphere_pt_host(const int32_t* ip, const float* fp,
                       const int32_t* sched, const float* spheres,
                       const float* lights, float* accum, float* output,
                       uint32_t* rng_state) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  p.lights = lights;
  return l2n::dispatch_fused<RenderTiles>(
      p, p, l2n::scene_view(spheres, p.n_scene, p.fast_math != 0), sched,
      accum, output, rng_state);
}
// The packed triangle scene as the kernel's entry point takes it (its
// arrays in TriangleBuffers.kernel_arrays order, up to the shell's).
l2n::TriSceneView tri_scene(int m, int n_slabs, int tpad,
                            const float* mesh_bounds,
                            const int32_t* slab_count,
                            const float* slab_bounds, const float* sub_bounds,
                            const float* group_bounds, const float* inner_gap,
                            const float* balls, const float* tris,
                            const float* attrs, const float* shell,
                            const float* shell_tris) {
  l2n::TriSceneView s{};
  s.n = m;
  s.n_slabs = n_slabs;
  s.tpad = tpad;
  s.mesh_bounds = mesh_bounds;
  s.slab_count = slab_count;
  s.slab_bounds = slab_bounds;
  s.sub_bounds = sub_bounds;
  s.group_bounds = group_bounds;
  s.inner_gap = inner_gap;
  s.balls = balls;
  s.tris = tris;
  s.attrs = attrs;
  if (shell != nullptr && shell[0] > 0.0f) {
    s.shell = shell;
    s.shell_tris = shell_tris;
  }
  return s;
}
int l2n_triangle_pt_host(const int32_t* ip, const float* fp, int n_slabs,
                         int tpad, const int32_t* sched,
                         const float* mesh_bounds, const int32_t* slab_count,
                         const float* slab_bounds, const float* sub_bounds,
                         const float* group_bounds, const float* inner_gap,
                         const float* balls, const float* tris,
                         const float* attrs, const float* shell,
                         const float* shell_tris, const float* albedo,
                         const float* material, const float* lights,
                         float* accum, float* output, uint32_t* rng_state) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  p.lights = lights;
  const int m = p.n_scene;
  l2n::TriSceneView s =
      tri_scene(m, n_slabs, tpad, mesh_bounds, slab_count, slab_bounds,
                sub_bounds, group_bounds, inner_gap, balls, tris, attrs,
                shell, shell_tris);
  s.ar = albedo;
  s.ag = albedo + m;
  s.ab = albedo + 2 * m;
  s.mat = material;
  return l2n::dispatch_fused<RenderTiles>(p, p, s, sched, accum, output,
                                          rng_state);
}
// The header's visibility table over n spheres `bounds` (4, n) for the K
// scheduled tiles: rows of [count, kept indices..., -1...] (K, 1 + n).
void l2n_visibility_host(const int32_t* ip, const float* fp,
                         const int32_t* sched, const float* bounds, int n,
                         int32_t* out) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  for (int k = 0; k < p.k; ++k) {
    int32_t* row = out + static_cast<size_t>(k) * (n + 1);
    for (int i = 0; i <= n; ++i) row[i] = -1;
    row[0] = l2n::build_visible_serial(
        p, l2n::tile_cone(p, sched[2 * k], sched[2 * k + 1]),
        [&](int i, float& cx, float& cy, float& cz, float& r2) {
          cx = bounds[i];
          cy = bounds[n + i];
          cz = bounds[2 * n + i];
          r2 = bounds[3 * n + i];
        },
        n, row + 1);
  }
}
// The fused kernels' thread-to-pixel map over one tile: out[r * tw + c] is
// sub * tw + t of the thread t of block sub that renders pixel (r, c), -1
// for a pixel no thread renders.
void l2n_block_pixel_host(int th, int tw, int32_t* out) {
  l2n::PtParams p{};
  p.tile_height = th;
  p.tile_width = tw;
  for (int i = 0; i < th * tw; ++i) out[i] = -1;
  for (int sub = 0; sub < th; ++sub)
    for (int t = 0; t < tw; ++t) {
      int r, c;
      l2n::block_pixel(p, sub, t, r, c);
      if (r >= 0 && r < th && c >= 0 && c < tw) out[r * tw + c] = sub * tw + t;
    }
}
// The triangle walks' scan counters since the last call: scans, overflowed
// scans, the longest list; then zeroed.
void l2n_walk_stats_host(int64_t* out) {
  out[0] = g_scans;
  out[1] = g_overflows;
  out[2] = g_longest;
  g_scans = g_overflows = g_longest = 0;
}
void l2n_philox_host(uint32_t k0, uint32_t k1, const uint32_t* ctr,
                     uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t c[4] = {ctr[i], ctr[n + i], ctr[2 * n + i], ctr[3 * n + i]};
    l2n::philox4x32_10(k0, k1, c);
    for (int w = 0; w < 4; ++w) out[w * n + i] = c[w];
  }
}
// philox_bits' kernel over (k, h, 128) words: one Philox block per (lane,
// block), its words stored through philox_bits_slot; `writes` counts the
// stores of each word.
void l2n_philox_bits_host(uint32_t k0, uint32_t k1, int k, int h,
                          uint32_t* out, int32_t* writes) {
  const size_t per_draw = static_cast<size_t>(h) * 128;
  const uint32_t blocks = static_cast<uint32_t>((k + 3) / 4);
  for (uint32_t b = 0; b < blocks; ++b)
    for (size_t p = 0; p < per_draw; ++p) {
      uint32_t c[4] = {static_cast<uint32_t>(p), 0u, b, 0u};
      l2n::philox4x32_10(k0, k1, c);
      for (uint32_t w = 0; w < 4; ++w) {
        size_t offset;
        if (l2n::philox_bits_slot(static_cast<uint32_t>(p), b, w,
                                  static_cast<uint32_t>(k), per_draw,
                                  offset)) {
          out[offset] = c[w];
          ++writes[offset];
        }
      }
    }
}
// `draws` draw1s of each of n stateful streams (mode code rng) over state
// planes of n lanes, stepped in place; values (draws, n).
void l2n_stateful_draws_host(int rng, uint32_t* st, int64_t n, int draws,
                             float* out) {
  l2n::PtParams p{};
  for (int64_t i = 0; i < n; ++i) {
    if (rng == l2n::kRngTinyMT) {
      auto s = l2n::TinyMTSampler::load(p, st, n, i, 0, 0);
      for (int d = 0; d < draws; ++d) out[d * n + i] = s.draw1();
      s.store(st, n, i);
    } else {
      auto s = l2n::TausLCGSampler::load(p, st, n, i, 0, 0);
      for (int d = 0; d < draws; ++d) out[d * n + i] = s.draw1();
      s.store(st, n, i);
    }
  }
}
void l2n_threefry_host(uint32_t k0, uint32_t k1, const uint32_t* x0,
                       const uint32_t* x1, uint32_t* o0, uint32_t* o1,
                       int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t a = x0[i], b = x1[i];
    l2n::threefry2x32(k0, k1, a, b);
    o0[i] = a;
    o1[i] = b;
  }
}
void l2n_mandelbrot_host(const float* d, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = l2n::mandelbrot_le(d[i], d[n + i], d[2 * n + i]);
}
void l2n_sun_host(const float* d, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = l2n::sun_le(d[i], d[n + i], d[2 * n + i]);
}
// The camera rays of the step's form through pixel coordinates
// (px, py) + (u1, u2): xy (4, n) in, directions (3, n) out.
void l2n_camera_dirs_host(const int32_t* ip, const float* fp, const float* xy,
                          float* out, int64_t n) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  for (int64_t i = 0; i < n; ++i)
    l2n::camera_direction(p, xy[i], xy[n + i], xy[2 * n + i], xy[3 * n + i],
                          out[i], out[n + i], out[2 * n + i]);
}
// The full nearest-sphere sweep of rays (6, n) (origin, direction) over
// the spheres (7, count), fast_math from the step's parameters: t and the
// winner's index per ray.
void l2n_sphere_nearest_host(const int32_t* ip, const float* fp,
                             const float* spheres, const float* rays,
                             float* t, int32_t* index, int64_t n) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  const l2n::SceneView s =
      l2n::scene_view(spheres, p.n_scene, p.fast_math != 0);
  for (int64_t i = 0; i < n; ++i) {
    const float* r = rays + i;
    const l2n::Hit h = s.nearest(r[0], r[n], r[2 * n], r[3 * n], r[4 * n],
                                 r[5 * n]);
    t[i] = h.t;
    index[i] = h.index;
  }
}
// The triangle walk's casts (csrc/triangle_pt.cuh TriSceneView) of n rays
// (6, n) over the packed scene, every mesh a candidate: `cast` 0 the
// nearest hit (t, index), 1 the any-hit, 2 the ambient-occlusion cast
// (`occluded`, any direction length) (index = the hit flag, t = 0); `seed`
// the seed that each cast's seeded walk took (L2N_NOTE_SEED).
void l2n_triangle_cast_host(int cast, int m, int n_slabs, int tpad,
                            const float* mesh_bounds,
                            const int32_t* slab_count,
                            const float* slab_bounds, const float* sub_bounds,
                            const float* group_bounds, const float* inner_gap,
                            const float* balls, const float* tris,
                            const float* attrs, const float* shell,
                            const float* shell_tris, const float* rays,
                            float* t, int32_t* index, float* seed,
                            int64_t n) {
  const l2n::TriSceneView s =
      tri_scene(m, n_slabs, tpad, mesh_bounds, slab_count, slab_bounds,
                sub_bounds, group_bounds, inner_gap, balls, tris, attrs,
                shell, shell_tris);
  for (int64_t i = 0; i < n; ++i) {
    const float* r = rays + i;
    const float o[3] = {r[0], r[n], r[2 * n]};
    const float d[3] = {r[3 * n], r[4 * n], r[5 * n]};
    t[i] = 0.0f;
    g_seed = NAN;
    g_ray = static_cast<int32_t>(i);
    if (cast == 0) {
      const l2n::Hit h = s.nearest(o[0], o[1], o[2], d[0], d[1], d[2]);
      t[i] = h.t;
      index[i] = h.index;
    } else if (cast == 1) {
      index[i] = s.anyhit(o[0], o[1], o[2], d[0], d[1], d[2]);
    } else {
      index[i] = s.occluded(o[0], o[1], o[2], d[0], d[1], d[2]);
    }
    seed[i] = g_seed;
  }
}
// The shell visits since the last call: misses, windows, wide chords,
// windows that walked the slabs too; then zeroed.
void l2n_shell_stats_host(int64_t* out) {
  for (int k = 0; k < 4; ++k) {
    out[k] = g_shell[k];
    g_shell[k] = 0;
  }
}
// Start (on) or stop logging the shell visits; starting drops the log.
void l2n_shell_log_host(int on) {
  g_shell_log = on != 0;
  if (on) {
    g_shell_rec.clear();
    g_shell_lim.clear();
  }
}
// The logged visits: their count, and with rec/lim non-null, the rows
// (count, 7) and t_lim (count,).
int64_t l2n_shell_records_host(int32_t* rec, float* lim) {
  const int64_t n = static_cast<int64_t>(g_shell_lim.size());
  if (rec != nullptr) {
    for (size_t i = 0; i < g_shell_rec.size(); ++i) rec[i] = g_shell_rec[i];
    for (size_t i = 0; i < g_shell_lim.size(); ++i) lim[i] = g_shell_lim[i];
  }
  return n;
}
// The fallback walks since the last call.
int64_t l2n_fallbacks_host() {
  const int64_t f = g_fallbacks;
  g_fallbacks = 0;
  return f;
}
int l2n_wavefront_pass_a_host(const int32_t* ip, const float* fp,
                              const int32_t* sched, const float* spheres,
                              const float* accum, float* col, float* back,
                              float* rays, int32_t* meta, int32_t* n_alive) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  const l2n::PassALanes out{col, back, rays, meta};
  return dispatch_pass<PassA>(p, p, sched, spheres, accum, out, n_alive);
}
int l2n_wavefront_pass_b_host(const int32_t* ip, const float* fp, int group,
                              int next_pair, int has_spare,
                              const int32_t* n_alive, const float* spheres,
                              const float* rays, const int32_t* meta,
                              float* col, float* back) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  return dispatch_pass<PassB>(p, p, group, next_pair, has_spare, n_alive,
                              spheres, rays, meta, col, back);
}
int l2n_group_size_host(int64_t alive, int64_t threads) {
  return l2n::group_size(alive, threads);
}
// The material modes' BSDFs (csrc/brdf.cuh) over n lanes of (3, n) planes
// n, wo, wi, kd and (6, n) material rows: f (3, n) and pdf (n,).
void l2n_eval_material_host(int mode, const float* nv, const float* wo,
                            const float* wi, const float* kd,
                            const float* mat, int64_t n, float* f,
                            float* pdf) {
  for (int64_t i = 0; i < n; ++i) {
    const float a[3] = {nv[i], nv[n + i], nv[2 * n + i]};
    const float o[3] = {wo[i], wo[n + i], wo[2 * n + i]};
    const float l[3] = {wi[i], wi[n + i], wi[2 * n + i]};
    const float k[3] = {kd[i], kd[n + i], kd[2 * n + i]};
    float fi[3];
    pdf[i] = l2n::eval_material(mode, a, o, l, k,
                                l2n::material_row(mat, n, i), fi);
    for (int c = 0; c < 3; ++c) f[c * n + i] = fi[c];
  }
}
// One draw of the mode's mixture per lane: u (3, n) = (u_lobe, u1, u2), the
// exact frame around the unit normal n; wi, w (3, n) and pdf (n,).
void l2n_sample_material_host(int mode, const float* u, const float* nv,
                              const float* wo, const float* kd,
                              const float* mat, int64_t n, float* wi,
                              float* w, float* pdf) {
  for (int64_t i = 0; i < n; ++i) {
    const l2n::Frame fr =
        l2n::frame_z(nv[i], nv[n + i], nv[2 * n + i], false);
    const float o[3] = {wo[i], wo[n + i], wo[2 * n + i]};
    const float k[3] = {kd[i], kd[n + i], kd[2 * n + i]};
    float wii[3], wi3[3];
    pdf[i] = l2n::sample_material(mode, u[i], u[n + i], u[2 * n + i], fr, o,
                                  k, l2n::material_row(mat, n, i), wii, wi3);
    for (int c = 0; c < 3; ++c) {
      wi[c * n + i] = wii[c];
      w[c * n + i] = wi3[c];
    }
  }
}
// The bump (csrc/brdf.cuh perturb_normal) of n lanes: amplitude (n,),
// points and normals (3, n) -> the unit bumped normals (3, n).
void l2n_perturb_normal_host(const int32_t* ip, const float* fp,
                             const float* bump, const float* pts,
                             const float* nv, int64_t n, float* out) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  for (int64_t i = 0; i < n; ++i) {
    float x = nv[i], y = nv[n + i], z = nv[2 * n + i];
    l2n::perturb_normal(p, bump[i], pts[i], pts[n + i], pts[2 * n + i], x, y,
                        z);
    out[i] = x;
    out[n + i] = y;
    out[2 * n + i] = z;
  }
}
// The explicit lights' loop (csrc/pathtrace.cuh explicit_lights) over the
// sphere scene (13, n_s) with Lambert's kd / pi, at n lanes of vertices h,
// normals nv, albedo kd and throughput tp (3, n): col (3, n) gets the
// direct term added (with fog's transmittance where p.fog).
void l2n_explicit_lights_host(const int32_t* ip, const float* fp,
                              const float* spheres, const float* lights,
                              const float* h, const float* nv,
                              const float* kd, const float* tp, int64_t n,
                              float* col) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  p.lights = lights;
  const l2n::SceneView s =
      l2n::scene_view(spheres, p.n_scene, p.fast_math != 0);
  for (int64_t i = 0; i < n; ++i) {
    const float k[3] = {kd[i], kd[n + i], kd[2 * n + i]};
    const float t[3] = {tp[i], tp[n + i], tp[2 * n + i]};
    float c[3] = {col[i], col[n + i], col[2 * n + i]};
    const auto eval = [&](const float*, float* f) {
      for (int ch = 0; ch < 3; ++ch) f[ch] = k[ch] * l2n::kInvPi;
    };
    if (p.fog)
      l2n::explicit_lights<true>(p, s, h[i], h[n + i], h[2 * n + i], nv[i],
                                 nv[n + i], nv[2 * n + i], eval, t, c);
    else
      l2n::explicit_lights<false>(p, s, h[i], h[n + i], h[2 * n + i], nv[i],
                                  nv[n + i], nv[2 * n + i], eval, t, c);
    for (int ch = 0; ch < 3; ++ch) col[ch * n + i] = c[ch];
  }
}
void l2n_nee_area_host(const int32_t* ip, const float* fp,
                       const float* spheres, int mode, int mis,
                       const float* u, const float* h, const float* nv,
                       const float* nu, const float* wo, const float* kd,
                       const float* mat, const float* tp, int64_t n,
                       float* col) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  nee_lanes(p, l2n::scene_view(spheres, p.n_scene, false), mode, mis, u, h,
            nv, nu, wo, kd, mat, tp, n, col);
}
void l2n_nee_cone_host(const int32_t* ip, const float* fp, int n_slabs,
                       int tpad, const float* mesh_bounds,
                       const int32_t* slab_count, const float* slab_bounds,
                       const float* sub_bounds, const float* group_bounds,
                       const float* inner_gap, const float* balls,
                       const float* tris, const float* attrs,
                       const float* shell, const float* shell_tris, int mode,
                       int mis, const float* u, const float* h,
                       const float* nv, const float* nu, const float* wo,
                       const float* kd, const float* mat, const float* tp,
                       int64_t n, float* col) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  const l2n::TriSceneView s =
      tri_scene(p.n_scene, n_slabs, tpad, mesh_bounds, slab_count,
                slab_bounds, sub_bounds, group_bounds, inner_gap, balls, tris,
                attrs, shell, shell_tris);
  nee_lanes(p, s, mode, mis, u, h, nv, nu, wo, kd, mat, tp, n, col);
}
// The MIS weight of emission found at n hits (t, normal nrm (3, n), r2,
// index) by BSDF rays of directions d (3, n) and pdfs prev_pdf: over the
// spheres (13, count) (area), or over the mesh bounds (count, 4) (cone).
void l2n_mis_weight_host(const int32_t* ip, const float* fp, int cone,
                         const float* scene, const float* prev_pdf,
                         const float* d, const float* t, const float* nrm,
                         const float* r2, const int32_t* index, int64_t n,
                         float* out) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  l2n::TriSceneView ts{};
  ts.mesh_bounds = scene;
  const l2n::SceneView ss = l2n::scene_view(scene, p.n_scene, false);
  for (int64_t i = 0; i < n; ++i) {
    l2n::Hit h{};
    h.t = t[i];
    h.nx = nrm[i];
    h.ny = nrm[n + i];
    h.nz = nrm[2 * n + i];
    h.index = index[i];
    h.r2 = r2[i];
    out[i] = cone ? l2n::mis_emission_weight(p, ts, prev_pdf[i], d[i],
                                             d[n + i], d[2 * n + i], h)
                  : l2n::mis_emission_weight(p, ss, prev_pdf[i], d[i],
                                             d[n + i], d[2 * n + i], h);
  }
}
int l2n_wavefront_pass_c_host(const int32_t* ip, const float* fp,
                              const int32_t* sched, const float* col,
                              const float* back, float* accum,
                              float* output) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, fp + l2n::kFloatParams);
  for (int k = 0; k < p.k; ++k)
    for (int r = 0; r < p.tile_height; ++r)
      for (int c = 0; c < p.tile_width; ++c)
        l2n::wavefront_pass_c_pixel(p, k, r, c, sched, col, back, accum,
                                    output);
  return 0;
}
// The probes' per-lane bodies over `lanes` lanes: sweep_variants' vpu
// (carry) / vpu2 lane and onehot_recovery's carry / gather lane.
void l2n_sweep_lanes_host(int carry, const float* o, const float* d,
                          const float* rows, int n, int64_t lanes,
                          int repeats, const float* bias, float* out) {
  const l2n_probe::Spheres s{rows, n};
  for (int64_t p = 0; p < lanes; ++p) {
    const float* a = o + p;
    const float* b = d + p;
    out[p] = carry ? l2n_probe::sweep_lane<true>(
                         s, repeats, a[0], a[lanes], a[2 * lanes], b[0],
                         b[lanes], b[2 * lanes], bias[p])
                   : l2n_probe::sweep_lane<false>(
                         s, repeats, a[0], a[lanes], a[2 * lanes], b[0],
                         b[lanes], b[2 * lanes], bias[p]);
  }
}
int l2n_sweep_chunked_host(int carry, int chunk, const float* o,
                           const float* d, const float* rows, int n,
                           int64_t lanes, int repeats, const float* bias,
                           float* out) {
  std::vector<l2n_probe::Sphere4> packed(n);
  for (int j = 0; j < n; ++j) packed[j] = l2n_probe::packed_sphere(rows, n, j);
  const l2n_probe::Sphere4* s = packed.data();
  switch (chunk) {
    case 1: sweep_chunked_lanes<1>(carry, o, d, s, n, lanes, repeats, bias, out); break;
    case 2: sweep_chunked_lanes<2>(carry, o, d, s, n, lanes, repeats, bias, out); break;
    case 4: sweep_chunked_lanes<4>(carry, o, d, s, n, lanes, repeats, bias, out); break;
    case 8: sweep_chunked_lanes<8>(carry, o, d, s, n, lanes, repeats, bias, out); break;
    case 16: sweep_chunked_lanes<16>(carry, o, d, s, n, lanes, repeats, bias, out); break;
    default: return 1;
  }
  return 0;
}
// sweep_mma over `lanes` lanes as its kernel decides (csrc/
// sweep_variants.cu), the tensor cores' sums emulated (`emulated_sum`
// mode): per (lane, sphere) the miss threshold T, per repeat D over
// the 12 slots (8 products from C = 0, then 4 more from that), |D| < T
// rejects, the rest resolved exactly and kept by their key; then each
// repeat's row. out (lanes,); index (repeats, lanes) or null; rejected
// (lanes, n, repeats) and threshold (lanes, n) or null.
void l2n_sweep_mma_host(int mode, const float* o, const float* d,
                        const float* cmat, int n, int64_t lanes, int repeats,
                        const float* bias, float* out, int32_t* index,
                        uint8_t* rejected, float* threshold) {
  using namespace l2n_probe;
  std::vector<MmaSphere> sph(n);
  std::vector<float> slots(static_cast<size_t>(n) * kMmaSlots);
  for (int j = 0; j < n; ++j) {
    sph[j] = mma_sphere(cmat[j], cmat[n + j], cmat[2 * n + j],
                        cmat[3 * n + j], cmat[4 * n + j]);
    float sj[kMmaSlots];
    mma_sphere_slots(cmat[j], cmat[n + j], cmat[2 * n + j], sj);
    for (int k = 0; k < kMmaSlots; ++k) slots[j * kMmaSlots + k] = sj[k];
  }
  const float scale_max = perturb_scale(repeats > 0 ? repeats - 1 : 0);
  std::vector<uint64_t> keys(repeats);
  for (int64_t p = 0; p < lanes; ++p) {
    const float ox = o[p], oy = o[lanes + p], oz = o[2 * lanes + p];
    const float dx0 = d[p], dy = d[lanes + p], dz = d[2 * lanes + p];
    const MmaLane lane = mma_lane(ox, oy, oz, dx0, dy, dz, scale_max);
    for (int r = 0; r < repeats; ++r) keys[r] = kMmaNoHit;
    for (int j = 0; j < n; ++j) {
      const float t = mma_threshold(mma_pair_c_lower(lane, sph[j]), sph[j].c1,
                                    lane);
      if (threshold != nullptr) threshold[p * n + j] = t;
      for (int r = 0; r < repeats; ++r) {
        const float dx = dx0 * perturb_scale(r);
        float ls[kMmaSlots], prod[kMmaSlots];
        mma_lane_slots(dx, dy, dz, ox * dx + oy * dy + oz * dz, ls);
        for (int k = 0; k < kMmaSlots; ++k)
          prod[k] = ls[k] * slots[j * kMmaSlots + k];
        const float dd = emulated_sum(mode, emulated_sum(mode, 0.0f, prod, 8),
                                      prod + 8, 4);
        const bool rej = fabsf(dd) < t;
        if (rejected != nullptr) rejected[(p * n + j) * repeats + r] = rej;
        if (rej) continue;
        const float tk = mma_resolve_t(ox, oy, oz, dx, dy, dz, sph[j]);
        if (tk < kBig && mma_key(tk, j) < keys[r]) keys[r] = mma_key(tk, j);
      }
    }
    float acc = bias[p];
    for (int r = 0; r < repeats; ++r) {
      const Winner w = mma_winner(keys[r], sph.data());
      acc = acc + mma_row(w);
      if (index != nullptr) index[r * lanes + p] = w.i;
    }
    out[p] = acc;
  }
}
void l2n_onehot_lanes_host(int carry, const float* rays, const float* rows,
                           int n, const float* table, int64_t lanes,
                           float* out) {
  const l2n_probe::Spheres s{rows, n};
  for (int64_t p = 0; p < lanes; ++p) {
    const float* r = rays + p;
    l2n_probe::Winner w;
    if (carry) {
      w = l2n_probe::sweep<true, l2n_probe::T1Only>(
          s, r[0], r[lanes], r[2 * lanes], r[3 * lanes], r[4 * lanes],
          r[5 * lanes], 1.0f);
    } else {
      w = l2n_probe::sweep<false, l2n_probe::T1Only>(
          s, r[0], r[lanes], r[2 * lanes], r[3 * lanes], r[4 * lanes],
          r[5 * lanes], 1.0f);
      l2n_probe::gather(table, 8, 1, w);
    }
    const float v[6] = {w.t, static_cast<float>(w.i), w.cx, w.cy, w.cz,
                        w.r2};
    for (int k = 0; k < 6; ++k) out[k * lanes + p] = v[k];
  }
}
int l2n_onehot_split_host(int carry, int group, const float* rays,
                          const float* rows, int n, const float* table,
                          int64_t lanes, float* out) {
  std::vector<l2n_probe::Sphere4> packed(n);
  for (int j = 0; j < n; ++j) packed[j] = l2n_probe::packed_sphere(rows, n, j);
  const l2n_probe::Sphere4* s = packed.data();
  switch (group) {
    case 1: onehot_split_group<1>(carry, rays, s, n, table, lanes, out); break;
    case 2: onehot_split_group<2>(carry, rays, s, n, table, lanes, out); break;
    case 4: onehot_split_group<4>(carry, rays, s, n, table, lanes, out); break;
    case 8: onehot_split_group<8>(carry, rays, s, n, table, lanes, out); break;
    case 16: onehot_split_group<16>(carry, rays, s, n, table, lanes, out); break;
    case 32: onehot_split_group<32>(carry, rays, s, n, table, lanes, out); break;
    default: return 1;
  }
  return 0;
}
}
"""


def _build_shim(tmp_path_factory, *defines):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "shim.cpp").write_text(SHIM)
    out = d / "libsphere_pt_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", *defines, f"-I{CSRC}", str(d / "shim.cpp"),
                    "-o", str(out)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.l2n_sphere_pt_host.argtypes = [p] * 8
    lib.l2n_sphere_pt_host.restype = ctypes.c_int
    lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 18
    lib.l2n_triangle_pt_host.restype = ctypes.c_int
    lib.l2n_visibility_host.argtypes = [p, p, p, p, ctypes.c_int, p]
    lib.l2n_walk_stats_host.argtypes = [p]
    lib.l2n_block_pixel_host.argtypes = [ctypes.c_int, ctypes.c_int, p]
    u32 = ctypes.c_uint32
    lib.l2n_philox_host.argtypes = [u32, u32, p, p, ctypes.c_int64]
    lib.l2n_philox_bits_host.argtypes = [u32, u32, ctypes.c_int,
                                         ctypes.c_int, p, p]
    lib.l2n_stateful_draws_host.argtypes = [ctypes.c_int, p, ctypes.c_int64,
                                            ctypes.c_int, p]
    lib.l2n_threefry_host.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                      p, p, p, p, ctypes.c_int64]
    lib.l2n_mandelbrot_host.argtypes = [p, p, ctypes.c_int64]
    lib.l2n_sun_host.argtypes = [p, p, ctypes.c_int64]
    lib.l2n_camera_dirs_host.argtypes = [p, p, p, p, ctypes.c_int64]
    lib.l2n_sphere_nearest_host.argtypes = [p] * 6 + [ctypes.c_int64]
    lib.l2n_triangle_cast_host.argtypes = [ctypes.c_int] * 4 + [p] * 15 + [
        ctypes.c_int64]
    lib.l2n_fallbacks_host.restype = ctypes.c_int64
    lib.l2n_shell_stats_host.argtypes = [p]
    lib.l2n_shell_log_host.argtypes = [ctypes.c_int]
    lib.l2n_shell_records_host.argtypes = [p, p]
    lib.l2n_shell_records_host.restype = ctypes.c_int64
    i = ctypes.c_int
    lib.l2n_wavefront_pass_a_host.argtypes = [p] * 10
    lib.l2n_wavefront_pass_b_host.argtypes = [p, p, i, i, i, p, p, p, p, p,
                                              p]
    lib.l2n_group_size_host.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.l2n_eval_material_host.argtypes = [i] + [p] * 5 + [ctypes.c_int64,
                                                          p, p]
    lib.l2n_sample_material_host.argtypes = [i] + [p] * 5 + [
        ctypes.c_int64, p, p, p]
    lib.l2n_perturb_normal_host.argtypes = [p] * 5 + [ctypes.c_int64, p]
    lib.l2n_explicit_lights_host.argtypes = [p] * 8 + [ctypes.c_int64, p]
    lib.l2n_wavefront_pass_c_host.argtypes = [p] * 7
    lib.l2n_nee_area_host.argtypes = [p, p, p, i, i] + [p] * 8 + [
        ctypes.c_int64, p]
    lib.l2n_nee_cone_host.argtypes = [p, p, i, i] + [p] * 11 + [i, i] + [
        p] * 8 + [ctypes.c_int64, p]
    lib.l2n_mis_weight_host.argtypes = [p, p, i] + [p] * 7 + [
        ctypes.c_int64, p]
    i64 = ctypes.c_int64
    lib.l2n_sweep_lanes_host.argtypes = [i, p, p, p, i, i64, i, p, p]
    lib.l2n_sweep_chunked_host.argtypes = [i, i, p, p, p, i, i64, i, p, p]
    lib.l2n_sweep_chunked_host.restype = ctypes.c_int
    lib.l2n_sweep_mma_host.argtypes = [i, p, p, p, i, i64, i, p, p, p, p, p]
    lib.l2n_onehot_lanes_host.argtypes = [i, p, p, i, p, i64, p]
    lib.l2n_onehot_split_host.argtypes = [i, i, p, p, i, p, i64, p]
    lib.l2n_onehot_split_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build_shim(tmp_path_factory)


@pytest.fixture(scope="module")
def lib_list1(tmp_path_factory):
    """The headers with a one-entry per-lane mesh list: every ray that
    enters two meshes walks them in chunks (csrc/triangle_pt.cuh walk)."""
    return _build_shim(tmp_path_factory, "-DL2N_LANE_LIST=1")


def _walk_stats(host_lib):
    """(scans, overflowed scans, longest list) of the triangle walks since
    the last call."""
    out = np.zeros(3, np.int64)
    host_lib.l2n_walk_stats_host(_ptr(out))
    return tuple(int(x) for x in out)


def _scene_ptrs(buf):
    """Pointers to the packed scene's arrays the walk reads
    (TriangleBuffers.kernel_arrays up to the shell's; contiguous tensors,
    whose memory `buf` keeps alive)."""
    return [_ptr(a.numpy()) for a in buf.kernel_arrays()[:11]]


def _cast(host_lib, cast, buf, rays, seeds=False):
    """The header's casts of rays (6, n) over `buf`, every mesh a
    candidate: (t, index) of `nearest` (cast 0), or (0, hit flag) of
    `anyhit` (1) and `occluded` (2); with `seeds`, also the seed that
    each cast's seeded walk took."""
    rays = np.ascontiguousarray(rays, np.float32)
    n = rays.shape[1]
    t, index = np.empty(n, np.float32), np.empty(n, np.int32)
    seed = np.empty(n, np.float32)
    m, s = buf.slab_bounds.shape[:2]
    host_lib.l2n_triangle_cast_host(cast, m, s, s * 128, *_scene_ptrs(buf),
                                    _ptr(rays), _ptr(t), _ptr(index),
                                    _ptr(seed), n)
    return (t, index, seed) if seeds else (t, index)


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def host_params(cfg, k, n_scene, camera, lights=None):
    """common.step_params for the shim's entry points: its ints, and its
    floats followed by the packed camera's 40 floats (module doc)."""
    from l2n_tpu_torch.ops.kernels.common import step_params
    ip, fp = step_params(cfg, k, n_scene, camera, lights)
    return ip, np.concatenate([fp, np.asarray(camera, np.float32).ravel()])


@pytest.fixture(scope="module")
def asan_build(tmp_path_factory):
    """build(*defines) -> (the shim built with AddressSanitizer, the ASan
    runtime), compiled once per set of defines for the module (~30 s a
    build)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    asan = subprocess.run([cxx, "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not Path(asan).is_file():
        pytest.skip("no AddressSanitizer runtime")
    built = {}

    def build(*defines):
        if defines not in built:
            d = tmp_path_factory.mktemp("asan")
            (d / "shim.cpp").write_text(SHIM)
            lib_path = d / "libtriangle_asan.so"
            subprocess.run([cxx, "-O1", "-g", "-fsanitize=address",
                            "-fno-omit-frame-pointer", "-ffp-contract=off",
                            "-std=c++17", "-shared", "-fPIC", *defines,
                            f"-I{CSRC}", str(d / "shim.cpp"), "-o",
                            str(lib_path)],
                           check=True, capture_output=True, text=True)
            built[defines] = lib_path
        return built[defines], asan

    return build


def _mixed_rays(buf, per_mesh, n=1536, seed=23):
    """Rays (6, n): tests/test_torch_csrc.py's surface rays (from outside,
    bounces half into the solid, bounces started 1e-3 along), a third of
    them aimed within 2 degrees of a mesh's pole axis so that the shell
    visits' windows reach the pole rows and wrap phi. `per_mesh`: the
    shell buffer's (M, 8) rows (cx cy cz r ...) of a lat/long scene."""
    soup = {k: v.numpy() for k, v in buf.soup.items()}
    gen = np.random.Generator(np.random.PCG64(seed))
    ti = gen.integers(0, soup["v1x"].shape[0], n)
    u = gen.random(n)
    v = gen.random(n) * (1.0 - u)
    p = np.stack([soup[f"v1{a}"][ti] + u * soup[f"e1{a}"][ti]
                  + v * soup[f"e2{a}"][ti] for a in "xyz"], 1)
    d = gen.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mesh = soup["mesh_id"][ti]
    c, r = per_mesh[mesh, :3].astype(np.float64), per_mesh[mesh, 3]
    k = n // 3
    # Polar rays: a point within 2 degrees of a pole, reached from outside.
    pol = slice(2 * k, n)
    npol = n - 2 * k
    sign = np.where(gen.random(npol) < 0.5, -1.0, 1.0)
    tilt = np.radians(2.0) * gen.random(npol)
    az = 2 * np.pi * gen.random(npol)
    nrm = np.stack([np.sin(tilt) * np.sin(az), sign * np.cos(tilt),
                    np.sin(tilt) * np.cos(az)], 1)
    p[pol] = c[pol] + nrm * r[pol, None]
    reach = r[:k] * (2.0 + 4.0 * gen.random(k))
    o = p.copy()
    o[:k] = p[:k] - d[:k] * reach[:, None]
    o[k:2 * k] = p[k:2 * k] + 1e-3 * d[k:2 * k]
    aim = -nrm + 0.3 * gen.normal(size=(npol, 3))
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    d[pol] = aim
    o[pol] = p[pol] - aim * (r[pol] * (1.5 + gen.random(npol)))[:, None]
    return np.ascontiguousarray(
        np.concatenate([o, d], 1).astype(np.float32).T)


ASAN_RENDER = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import RNG_CODES
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import (build_triangle_scene, compute_spheres,
                                 load_obj, torus_field_obj)
from torch_csrc_shim import host_params
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 18
cfg = RenderConfig(width=128, height=64, scene_kind="triangle",
                   aov=sys.argv[2] if len(sys.argv) > 2 else "pathtracing")
cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
for scene in (build_triangle_scene(compute_spheres(128)),
              load_obj(torus_field_obj())):
    buf = TriangleBuffers.from_scene(scene)
    m, s = buf.slab_bounds.shape[:2]
    sched = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    ip, fp = host_params(cfg, cfg.tile_count, m, Camera.from_config(cfg).packed())
    arrays = [ip, fp] + [t.numpy() for t in (
        sched, *buf.kernel_arrays(), accum, output)]
    ptrs = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
    for _ in range(2):
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:16],
                                        None, *ptrs[16:], None) == 0
    assert float(accum[3].sum()) == 2 * cfg.padded_height * cfg.padded_width
print("clean")
"""


def _asan_render(asan_build, *defines, script=ASAN_RENDER, args=()):
    """Run `script` with the ASan build of the shim (argv[1]) and `args`,
    the repository and this directory on its path; it prints "clean"."""
    lib_path, asan = asan_build(*defines)
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([str(CSRC.parents[1]),
                                           str(Path(__file__).parent)]))
    proc = subprocess.run([sys.executable, "-c", script, str(lib_path), *args],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
