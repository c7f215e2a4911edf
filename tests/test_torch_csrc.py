"""Host build of the CUDA kernels' per-pixel headers against the plain path.

`l2n_tpu_torch/csrc/pathtrace.cuh` holds the kernels' whole per-pixel path
body as `__host__ __device__` functions, `sphere_pt.cuh` and
`triangle_pt.cuh` the two scenes' traversals. Here g++ builds them
(-ffp-contract=off, the counterpart of nvcc's -fmad=false) into a small
ctypes library, the way l2n_tpu.native builds its C++ twin, and runs them
over every pixel of the scheduled tiles. That checks the kernels' draw
order, path logic, traversal and accumulation without a card; nvcc builds
the same headers on the chip (chip_smoke.py). Gates are those of
tests/test_native.py's threefry renderer test and of
tests/test_kernels.py::TestTriangleKernel. Every build in the port's tests
lives in this one file.
"""

import ctypes
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.camera.camera import slab_camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.envlight import SUN_S, mandelbrot_le, sun_le
from l2n_tpu_torch.ops.intersect import intersect_sphere_scene
from l2n_tpu_torch.ops.kernels.common import RNG_CODES, step_params
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits_plain
from l2n_tpu_torch.ops.kernels.sphere_pt import (
    sphere_pt_plain,
    visibility_table,
)
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    certain_hit_seed,
    takes_fallback,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.kernels.wavefront import (
    wavefront_pass_a_plain,
    wavefront_pass_b_plain,
    wavefront_pass_c_plain,
)
from l2n_tpu_torch.ops.pathtrace import (
    count_fog_collisions,
    generate_rays,
    wavefront_draw_position,
)
from l2n_tpu_torch.probes import onehot_recovery, sweep_variants
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.rng import philox, tauslcg, tinymt
from l2n_tpu_torch.rng.state import init_tauslcg_states, init_tinymt_states
from l2n_tpu_torch.rng.threefry import threefry2x32
from l2n_tpu_torch.scene import load_obj, torus_field_obj, trefoil_obj
from l2n_tpu_torch.scene.spheres import compute_spheres
from l2n_tpu_torch.scene.tessellate import build_triangle_scene


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


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
  l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  p.lights = lights;
  return l2n::dispatch_fused<RenderTiles>(
      p, p, l2n::scene_view(spheres, p.n_scene, p.fast_math != 0), sched,
      accum, output, rng_state);
}
// The packed triangle scene as the kernel's entry point takes it (its
// arrays in TriangleBuffers.kernel_arrays order, up to attrs).
l2n::TriSceneView tri_scene(int m, int n_slabs, int tpad,
                            const float* mesh_bounds,
                            const int32_t* slab_count,
                            const float* slab_bounds, const float* sub_bounds,
                            const float* group_bounds, const float* inner_gap,
                            const float* balls, const float* tris,
                            const float* attrs) {
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
  return s;
}
int l2n_triangle_pt_host(const int32_t* ip, const float* fp, int n_slabs,
                         int tpad, const int32_t* sched,
                         const float* mesh_bounds, const int32_t* slab_count,
                         const float* slab_bounds, const float* sub_bounds,
                         const float* group_bounds, const float* inner_gap,
                         const float* balls, const float* tris,
                         const float* attrs, const float* albedo,
                         const float* material, const float* lights,
                         float* accum, float* output, uint32_t* rng_state) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  p.lights = lights;
  const int m = p.n_scene;
  l2n::TriSceneView s =
      tri_scene(m, n_slabs, tpad, mesh_bounds, slab_count, slab_bounds,
                sub_bounds, group_bounds, inner_gap, balls, tris, attrs);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
                            const float* attrs, const float* rays, float* t,
                            int32_t* index, float* seed, int64_t n) {
  const l2n::TriSceneView s =
      tri_scene(m, n_slabs, tpad, mesh_bounds, slab_count, slab_bounds,
                sub_bounds, group_bounds, inner_gap, balls, tris, attrs);
  for (int64_t i = 0; i < n; ++i) {
    const float* r = rays + i;
    const float o[3] = {r[0], r[n], r[2 * n]};
    const float d[3] = {r[3 * n], r[4 * n], r[5 * n]};
    t[i] = 0.0f;
    g_seed = NAN;
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const l2n::PassALanes out{col, back, rays, meta};
  return dispatch_pass<PassA>(p, p, sched, spheres, accum, out, n_alive);
}
int l2n_wavefront_pass_b_host(const int32_t* ip, const float* fp, int group,
                              int next_pair, int has_spare,
                              const int32_t* n_alive, const float* spheres,
                              const float* rays, const int32_t* meta,
                              float* col, float* back) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  nee_lanes(p, l2n::scene_view(spheres, p.n_scene, false), mode, mis, u, h,
            nv, nu, wo, kd, mat, tp, n, col);
}
void l2n_nee_cone_host(const int32_t* ip, const float* fp, int n_slabs,
                       int tpad, const float* mesh_bounds,
                       const int32_t* slab_count, const float* slab_bounds,
                       const float* sub_bounds, const float* group_bounds,
                       const float* inner_gap, const float* balls,
                       const float* tris, const float* attrs, int mode,
                       int mis, const float* u, const float* h,
                       const float* nv, const float* nu, const float* wo,
                       const float* kd, const float* mat, const float* tp,
                       int64_t n, float* col) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const l2n::TriSceneView s =
      tri_scene(p.n_scene, n_slabs, tpad, mesh_bounds, slab_count,
                slab_bounds, sub_bounds, group_bounds, inner_gap, balls, tris,
                attrs);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
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
    lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 16
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
    lib.l2n_triangle_cast_host.argtypes = [ctypes.c_int] * 4 + [p] * 13 + [
        ctypes.c_int64]
    lib.l2n_fallbacks_host.restype = ctypes.c_int64
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
    lib.l2n_nee_cone_host.argtypes = [p, p, i, i] + [p] * 9 + [i, i] + [
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
    (TriangleBuffers.kernel_arrays up to attrs; contiguous tensors, whose
    memory `buf` keeps alive)."""
    return [_ptr(a.numpy()) for a in buf.kernel_arrays()[:9]]


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


@pytest.mark.parametrize("shape", [(32, 128), (32, 256), (16, 64),
                                   (30, 128), (32, 100)])
def test_block_pixel_renders_each_pixel_once(lib, shape):
    """csrc/pathtrace.cuh block_pixel, the fused kernels' thread-to-pixel
    map (tile_height blocks of tile_width threads per tile): every pixel of
    the tile exactly once; where the shape allows, each warp a 4 x 8
    rectangle, else each block one row."""
    th, tw = shape
    out = np.empty(th * tw, np.int32)
    lib.l2n_block_pixel_host(th, tw, _ptr(out))
    assert np.array_equal(np.sort(out), np.arange(th * tw))
    r, c = np.divmod(np.arange(th * tw), tw)
    if tw % 32 == 0 and th % 4 == 0:
        warp = out // 32
        for w in np.unique(warp):
            mine = warp == w
            assert np.ptp(r[mine]) == 3 and np.ptp(c[mine]) == 7
    else:
        np.testing.assert_array_equal(out // tw, r)


def test_threefry_header_bit_exact(lib):
    gen = np.random.Generator(np.random.PCG64(21))
    x0, x1 = gen.integers(0, 2**32, (2, 50_000), dtype=np.uint32)
    o0, o1 = np.empty_like(x0), np.empty_like(x1)
    lib.l2n_threefry_host(123, 4, _ptr(x0), _ptr(x1), _ptr(o0), _ptr(o1),
                          x0.size)
    t0, t1 = threefry2x32(123, 4, torch.from_numpy(x0.astype(np.int64)),
                          torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(o0.astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(o1.astype(np.int64), t1.numpy())


def test_mandelbrot_header_matches_plain(lib):
    gen = np.random.Generator(np.random.PCG64(22))
    d = gen.normal(size=(3, 50_000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[0] = np.abs(d[0])
    d = np.ascontiguousarray(d, np.float32)
    out = np.empty(d.shape[1], np.float32)
    lib.l2n_mandelbrot_host(_ptr(d), _ptr(out), d.shape[1])
    want = mandelbrot_le(*(torch.from_numpy(a) for a in d)).numpy()
    assert (want > 0).mean() > 0.05
    assert (out != want).mean() <= 1e-3


def test_sun_header_matches_plain(lib):
    """csrc/pathtrace.cuh sun_le per lane against the plain sky, bit-equal
    (subnormals included: neither build flushes them)."""
    gen = np.random.Generator(np.random.PCG64(41))
    d = gen.normal(size=(3, 50_000)).astype(np.float32)
    d[:, :5000] += 20.0 * np.float32(SUN_S) * np.array(
        [1, 1, -1], np.float32)[:, None]  # near the sun's direction
    d /= np.linalg.norm(d, axis=0)
    d = np.ascontiguousarray(d, np.float32)
    out = np.empty(d.shape[1], np.float32)
    lib.l2n_sun_host(_ptr(d), _ptr(out), d.shape[1])
    want = sun_le(*(torch.from_numpy(a) for a in d)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    assert (want > 1e-2).sum() > 1000 and (want == 0).sum() > 10_000


@pytest.mark.parametrize("ray_gen", ["fovy", "viewproj"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_math"])
def test_camera_direction_header_matches_plain(lib, ray_gen, fast):
    """csrc/pathtrace.cuh camera_direction (fovy_direction or
    viewproj_direction, normalized exactly or by rsqrt) per lane against the
    plain generate_rays on random pixels and jitters, bit-equal: the host
    build's rsqrt is the correctly rounded 1/sqrt the plain path takes on
    the CPU."""
    cfg = RenderConfig(width=1280, height=720, ray_gen=ray_gen,
                       fast_math=fast).validate()
    cam = Camera.from_config(cfg).packed()
    gen = np.random.Generator(np.random.PCG64(42))
    n = 20_000
    xy = np.ascontiguousarray(np.stack([
        gen.integers(0, cfg.width, n).astype(np.float32),
        gen.integers(0, cfg.height, n).astype(np.float32),
        *gen.random((2, n), dtype=np.float32)]))
    ip, fp = step_params(cfg, 1, 1, cam)
    out = np.empty((3, n), np.float32)
    lib.l2n_camera_dirs_host(_ptr(ip), _ptr(fp), _ptr(xy), _ptr(out), n)
    want = generate_rays(cfg, torch.from_numpy(cam),
                         *(torch.from_numpy(a) for a in xy))[3:]
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_math"])
def test_tangent_ray_header_matches_plain(lib, fast):
    """Rays tangent to a sphere with a discriminant of exactly 0 (the sweep's
    vote lets them through): the exact sweep hits at the tangent point, the
    fast-math one takes 0 * rsqrt(0) = NaN and misses, as the JAX package's
    fast_sqrt does; the header's full sweep equals the plain one either way,
    and a ray that meets the sphere properly hits in both."""
    spheres = np.zeros((7, 2), np.float32)
    spheres[:4, 0] = [0.0, 0.0, -5.0, 1.0]      # r = 1 at z = -5
    spheres[:4, 1] = [30.0, 30.0, 30.0, 4.0]    # out of the way
    spheres[4:] = 0.5
    # origin (x, 0, 0) looking down -z: hb = -5, c = x^2 + 25 - 1, so
    # disc = 1 - x^2 is exactly 0 at x = +-1 and positive at x = 0.5;
    # the fourth starts at y = 2 (disc = -3).
    rays = np.zeros((6, 4), np.float32)
    rays[0] = [1.0, -1.0, 0.5, 0.0]
    rays[1] = [0.0, 0.0, 0.0, 2.0]
    rays[5] = -1.0
    cfg = RenderConfig(fast_math=fast).validate()
    ip, fp = step_params(cfg, 1, 2, Camera.from_config(cfg).packed())
    t = np.empty(4, np.float32)
    idx = np.empty(4, np.int32)
    lib.l2n_sphere_nearest_host(_ptr(ip), _ptr(fp), _ptr(spheres),
                                _ptr(np.ascontiguousarray(rays)), _ptr(t),
                                _ptr(idx), 4)
    sp = torch.from_numpy(spheres)
    want = intersect_sphere_scene(*(torch.from_numpy(r) for r in rays),
                                  sp[0], sp[1], sp[2], sp[3], fast_math=fast)
    np.testing.assert_array_equal(t, want[0].numpy())
    np.testing.assert_array_equal(idx, want[7].numpy())
    tangent = [-1.0, -1.0] if fast else [5.0, 5.0]
    np.testing.assert_array_equal(t[:2], tangent)
    assert idx[2] == 0 and 4.0 < t[2] < 5.0  # x = 0.5 meets the sphere
    assert idx[3] == -1  # the fourth ray misses both


def _aimed_view(cfg):
    """Look from between a diffuse (odd) sphere and its nearest emissive
    (even) one at the diffuse sphere: a lit frame (cf. tests/test_brdf.py)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1)
    r = np.sqrt(sc.sqr_radius.numpy())
    odd, even = np.arange(1, cfg.sphere_count, 2), np.arange(0, cfg.sphere_count, 2)
    dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
    oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
    j, e = odd[oi], even[ei]
    to_e = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
    eye = c[j] + to_e * 5.0 * r[j]
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _render(cfg, cam, steps, host_lib=None, with_state=False):
    """accum, output (and the rng_state planes, or None) after `steps`
    steps of the plain step or of the host-built header."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    planes = init_rng_state(cfg)
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            sphere_pt_plain(cfg, sched, cam, spheres, accum, output, planes)
        else:
            ip, fp = step_params(cfg, k, sc.count, cam)
            s_np, sp_np = sched.numpy(), spheres.numpy()
            a_np, o_np = accum.numpy(), output.numpy()
            assert host_lib.l2n_sphere_pt_host(
                _ptr(ip), _ptr(fp), _ptr(s_np), _ptr(sp_np), None,
                _ptr(a_np), _ptr(o_np),
                None if planes is None else _ptr(planes.numpy())) == 0
    if with_state:
        return accum.numpy(), output.numpy(), planes
    return accum.numpy(), output.numpy()


def _inside_view(cfg, j):
    """The eye inside sphere j, a third of its radius off its centre,
    looking through its wall at the nearest other sphere (the d2 <= r2 case
    of the cone cull: sphere j is every tile's first hit)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1).astype(np.float64)
    d = np.linalg.norm(c - c[j], axis=1)
    d[j] = np.inf
    to = (c[np.argmin(d)] - c[j]) / d.min()
    eye = c[j] + to * np.sqrt(float(sc.sqr_radius[j])) / 3.0
    return look_at(eye.astype(np.float32), c[np.argmin(d)].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


@pytest.mark.parametrize("case", ["aimed", "default", "inside", "normal",
                                  "hit", "ao", "tex_coords", "sun_viewproj",
                                  "fast_math", "fast_ao_viewproj", "slab",
                                  "slab_tpu_hw"])
def test_header_matches_plain_step(lib, case):
    """The kernels' per-pixel body with their cone-culled primaries (the
    tile's visible list and its hoisted origin terms, csrc/cull.cuh) against
    the plain step, which sweeps every sphere: the aimed small scene, the
    default 128 spheres, and the eye inside an emissive sphere; and on the
    aimed scene the primary-only AOVs (normal, hit, ambient occlusion,
    tex_coords), the sun sky with the viewproj camera, and fast_math (the
    host build's rsqrt is the plain CPU path's); and a slab of a sharded
    frame (the lower half of the aimed 128x128 frame: row offset 64,
    stream 3, in threefry and tpu_hw), whose extras change the image."""
    if case.startswith("slab"):
        full = RenderConfig(width=128, height=128, sphere_count=16,
                            emissive_every=2,
                            rng="tpu_hw" if case.endswith("hw")
                            else "threefry").validate()
        cfg = full.replace(height=64, ndc_height=128)
        frame = Camera.from_config(full, _aimed_view(full)).packed()
        cam = slab_camera(frame, 64, 3)
        ha, ho = _render(cfg, cam, 4, host_lib=lib)
        pa, po = _render(cfg, cam, 4)
        assert (pa[:3].max(0) > 0).mean() > 0.3  # a lit slab
        np.testing.assert_array_equal(ha[3], pa[3])
        d = np.abs(ha - pa)
        assert np.sqrt((d ** 2).mean()) < 1e-3
        assert (np.abs(ho - po) > 1e-3).mean() < 2e-3
        for extras in ((0, 3), (64, 0)):  # each extra moves the image
            other = _render(cfg, slab_camera(frame, *extras), 4)[0]
            assert (np.abs(other - pa)[:3].max(0) > 0).mean() > 0.05
        return
    settings = {"normal": {"aov": "normal"}, "hit": {"aov": "hit"},
                "ao": {"aov": "ambient_occlusion"},
                "tex_coords": {"aov": "tex_coords"},
                "sun_viewproj": {"env_mode": "sun", "ray_gen": "viewproj"},
                "fast_math": {"fast_math": True},
                "fast_ao_viewproj": {"fast_math": True, "ray_gen": "viewproj",
                                     "aov": "ambient_occlusion"}}
    if case in settings:
        cfg = RenderConfig(width=128, height=64, sphere_count=16,
                           emissive_every=2, **settings[case]).validate()
        view = _aimed_view(cfg)
    elif case == "aimed":
        cfg = RenderConfig(width=128, height=64, sphere_count=16,
                           emissive_every=2).validate()
        view = _aimed_view(cfg)
    elif case == "inside":
        cfg = RenderConfig(width=128, height=64, sphere_count=16,
                           emissive_every=2).validate()
        view = _inside_view(cfg, 0)
    else:
        cfg = RenderConfig(width=128, height=64, sphere_count=128,
                           tiles_per_step=2).validate()
        view = None
    cam = Camera.from_config(cfg, view).packed()
    ha, ho = _render(cfg, cam, 4, host_lib=lib)
    pa, po = _render(cfg, cam, 4)
    if cfg.aov != "pathtracing":  # hits cover a tenth of the aimed view
        assert (np.abs(pa[:3]).max(0) > 0).mean() > 0.05
        np.testing.assert_array_equal(ha, pa)
    elif case != "default":
        assert (pa[:3].max(0) > 0).mean() > 0.3  # a lit frame
    assert (pa[3] > 0).all()
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


@pytest.mark.parametrize("case", ["default_spheres", "default_meshes",
                                  "inside", "viewproj_spheres",
                                  "viewproj_fast_meshes", "slab_spheres",
                                  "slab_viewproj_meshes"])
def test_visibility_header_matches_plain(lib, case):
    """csrc/cull.cuh's table (the kernels' per-tile visible list, built here
    serially with the same per-sphere test) equals the plain
    visibility_table on every tile of the 1280x720 frame: the default
    spheres, the default triangle scene's mesh bounds, and the eye inside a
    sphere; and with the viewproj camera (its corner rays, normalized
    exactly or by rsqrt, as the primaries are); and on a slab of the frame
    (its tile rows 10-14: row offset 320 and stream 5 in the camera, the
    plain table's row_offset 320), whose table is not the frame's first
    rows'."""
    cfg = RenderConfig().validate()
    frame_cfg, row_offset = cfg, 0
    if case.startswith("slab"):
        cfg = cfg.replace(height=160, ndc_height=720)
        row_offset = 320
    if "viewproj" in case:
        cfg = cfg.replace(ray_gen="viewproj",
                          fast_math=case.endswith("fast_meshes"))
        frame_cfg = frame_cfg.replace(ray_gen="viewproj")
    if case.endswith("meshes"):
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
        bounds = TriangleBuffers.from_scene(scene).mesh_bounds.T.contiguous()
    else:
        bounds = compute_spheres(cfg.sphere_count, cfg.world_size,
                                 cfg.scene_seed).packed()[:4].contiguous()
    view = _inside_view(cfg, 5) if case == "inside" else None
    cam = Camera.from_config(frame_cfg, view).packed()
    sched = torch.as_tensor(tile_grid(cfg))
    n = bounds.shape[1]
    ip, fp = step_params(cfg, cfg.tile_count, n,
                         slab_camera(cam, row_offset, 5 if row_offset else 0))
    got = np.empty((cfg.tile_count, n + 1), np.int32)
    lib.l2n_visibility_host(_ptr(ip), _ptr(fp), _ptr(sched.numpy()),
                            _ptr(bounds.numpy()), n, _ptr(got))
    want = visibility_table(cfg, bounds, cam, sched, row_offset).numpy()
    if row_offset:
        top = visibility_table(cfg, bounds, cam, sched).numpy()
        assert (top[:, 0] != want[:, 0]).any()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1:1 + w[0]], w[1:1 + w[0]])
    assert 0 < want[:, 0].max() and want[:, 0].mean() < n
    if case == "inside":
        assert all(5 in w[1:1 + w[0]] for w in want)


@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2, "max_bounces": 3},
                                   {"max_bounces": 1}, {"rng": "tpu_hw"},
                                   {"sphere_count": 13},
                                   {"env_mode": "sun", "ray_gen": "viewproj"},
                                   {"fast_math": True, "rng": "tpu_hw"}],
                         ids=["reference", "spp2_bounces3", "bounces1",
                              "tpu_hw", "spheres13", "sun_viewproj",
                              "fast_math"])
def test_wavefront_header_matches_plain_passes(lib, extra):
    """csrc/wavefront.cuh's per-lane pass A/B/C bodies against the plain
    passes on the same inputs, pass by pass, over 2 steps of the aimed
    config. Pass A's host append is serial in lane order, so its slots are
    the plain pass A's stable compaction. Bit-equal: n_alive, the meta
    planes (pixel, sample, lane), the partial radiance, back (0 at the dead
    lanes, untouched at the survivors'), the cast origin and throughput
    planes, pass B with each ray's sweeps split into 8 parts against 1
    (with 13 spheres, 8 does not divide the scene), and pass C's accum. The rest differs only through the C
    library's sinf/cosf/expf/logf against torch's vectorised CPU ones (both
    within an ulp or two; on the card nvcc's and torch's are the same
    functions, and chip_smoke.py expects max abs 0): the direction planes
    to 1e-5 relative on under 1% of lanes, pass B's contributions at the
    survivors' lanes under the fused header test's gates, pass C's output
    to 1e-6."""
    cfg = RenderConfig(**{"width": 128, "height": 64, "sphere_count": 16,
                          "emissive_every": 2, "wavefront": True,
                          **extra}).validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    k = cfg.effective_tiles_per_step
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    ip, fp = step_params(cfg, k, sc.count, cam)
    next_pair, has_spare = wavefront_draw_position(cfg)
    for i in range(2):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        a = wavefront_pass_a_plain(cfg, sched, cam, spheres, accum)
        h_col = torch.empty_like(a.col)
        h_back = torch.full_like(a.back, float("nan"))
        h_rays = torch.full_like(a.rays, float("nan"))
        h_meta = torch.full_like(a.meta, -7)
        h_n = torch.zeros(1, dtype=torch.int32)
        assert lib.l2n_wavefront_pass_a_host(
            _ptr(ip), _ptr(fp), *(_ptr(t.numpy()) for t in (
                sched, spheres, accum, h_col, h_back, h_rays, h_meta,
                h_n))) == 0
        na = int(a.n_alive[0])
        assert int(h_n[0]) == na and 0 < na < a.col[0].numel()
        np.testing.assert_array_equal(h_meta[:, :na].numpy(),
                                      a.meta[:, :na].numpy())
        np.testing.assert_array_equal(h_col.numpy(), a.col.numpy())
        np.testing.assert_array_equal(h_back.numpy(), a.back.numpy())
        for planes in (slice(0, 3), slice(6, 9)):  # origin, throughput
            np.testing.assert_array_equal(h_rays[planes, :na].numpy(),
                                          a.rays[planes, :na].numpy())
        hd, d = h_rays[3:6, :na].numpy(), a.rays[3:6, :na].numpy()
        np.testing.assert_allclose(hd, d, rtol=1e-5, atol=0)
        assert (hd != d).any(0).sum() < 1e-2 * a.col[0].numel()

        back = a.back.clone()
        wavefront_pass_b_plain(cfg, cam, spheres, a.rays, a.meta, a.n_alive,
                               back)
        assert not back.isnan().any()  # every survivor's lane written
        h_backs = []
        for group in (1, 8):
            h_backs.append(a.back.clone())
            assert lib.l2n_wavefront_pass_b_host(
                _ptr(ip), _ptr(fp), group, next_pair, int(has_spare),
                *(_ptr(t.numpy()) for t in (a.n_alive, spheres, a.rays,
                                            a.meta)), None,
                _ptr(h_backs[-1].numpy())) == 0
        for h in h_backs[1:]:
            np.testing.assert_array_equal(h.numpy(), h_backs[0].numpy())
        lanes = a.meta[2, :na].long()
        live = back.view(3, -1)[:, lanes]
        dc = (h_backs[0].view(3, -1)[:, lanes] - live).numpy()
        assert np.sqrt((dc ** 2).mean()) < 1e-3
        assert (np.abs(dc) > 1e-3).mean() < 2e-3
        if cfg.max_bounces > 1:  # one bounce sees only the sky, occluded
            assert live.max() > 0  # survivors found light

        h_accum, h_output = accum.clone(), output.clone()
        assert lib.l2n_wavefront_pass_c_host(
            _ptr(ip), _ptr(fp), *(_ptr(t.numpy()) for t in (
                sched, a.col, back, h_accum, h_output))) == 0
        wavefront_pass_c_plain(cfg, sched, a.col, back, accum, output)
        np.testing.assert_array_equal(h_accum.numpy(), accum.numpy())
        np.testing.assert_allclose(h_output.numpy(), output.numpy(), rtol=0,
                                   atol=1e-6)
    assert (accum[:3].amax(0) > 0).float().mean() > 0.3  # a lit frame


@pytest.mark.parametrize("alive,threads,want", [
    (0, 1024, 8), (100, 1024, 8), (128, 1024, 8), (129, 1024, 1),
    (300, 1024, 1), (513, 1024, 1), (10**6, 1024, 1)])
def test_group_size_header(lib, alive, threads, want):
    """Pass B's group: 8 lanes per ray while every survivor still gets its
    own group of 8 among the threads, else 1."""
    assert lib.l2n_group_size_host(alive, threads) == want


TRI_CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                       sphere_count=8, disc_lat=8, disc_long=4,
                       tiles_per_step=1, scene_kind="triangle").validate()


def _tri_aimed_camera(cfg):
    """tests/test_kernels.py::TestTriangleKernel.aimed_camera: up close at
    the emissive sphere 0."""
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c0 = np.array([float(sp.center_x[0]), float(sp.center_y[0]),
                   float(sp.center_z[0])], np.float32)
    r0 = float(np.sqrt(float(sp.sqr_radius[0])))
    vm = look_at(c0 + np.array([0.0, 0.0, 2.5 * r0], np.float32), c0,
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)


def _render_triangles(cfg, scene, cam, steps, host_lib=None):
    buf = TriangleBuffers.from_scene(scene)
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            triangle_pt_plain(cfg, sched, cam, buf, accum, output)
            continue
        m, s = buf.slab_bounds.shape[:2]
        ip, fp = step_params(cfg, k, m, cam)
        arrays = [sched, *buf.kernel_arrays()]
        assert host_lib.l2n_triangle_pt_host(
            _ptr(ip), _ptr(fp), s, s * 128,
            *(_ptr(a.numpy()) for a in arrays), None, _ptr(accum.numpy()),
            _ptr(output.numpy()), None) == 0
    return accum.numpy(), output.numpy()


@pytest.mark.parametrize("aov", ["pathtracing", "tex_coords", "param_uv",
                                 "normal", "hit", "ambient_occlusion",
                                 "sun_viewproj_fast", "slab", "slab_tpu_hw"])
def test_triangle_header_matches_plain_step(lib, aov):
    """The kernel's bound traversal (the culled primaries, then per lane
    its entered meshes front to back, mesh -> slab -> sub-cluster) against
    the plain brute-force sweep on the aimed small config, 2 steps; gates
    of tests/test_kernels.py:125-151, bit-equality expected: every AOV (the
    ambient-occlusion cast walks with its unnormalized direction), the
    sun sky with the viewproj camera under fast_math, and the frame's
    lower tile row as a slab of a sharded frame (row offset 32, stream 5,
    in threefry and tpu_hw)."""
    if aov == "sun_viewproj_fast":
        cfg = TRI_CFG.replace(env_mode="sun", ray_gen="viewproj",
                              fast_math=True)
        aov = "pathtracing"
        cam = _tri_aimed_camera(cfg).packed()
    elif aov.startswith("slab"):
        cfg = TRI_CFG.replace(height=32, ndc_height=64,
                              rng="tpu_hw" if aov.endswith("hw")
                              else "threefry")
        cam = slab_camera(_tri_aimed_camera(TRI_CFG).packed(), 32, 5)
        aov = "pathtracing"
    else:
        cfg = TRI_CFG.replace(aov=aov)
        cam = _tri_aimed_camera(cfg).packed()
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count,
                                                 cfg.world_size,
                                                 cfg.scene_seed),
                                 cfg.disc_lat, cfg.disc_long)
    _walk_stats(lib)
    ha, ho = _render_triangles(cfg, scene, cam, 2, host_lib=lib)
    assert _walk_stats(lib)[0] > 0  # through the per-lane walk
    pa, po = _render_triangles(cfg, scene, cam, 2)
    assert (pa[:3].max(0) > 0).mean() > 0.05  # a lit frame
    np.testing.assert_array_equal(ha[3], pa[3])
    d = np.abs(ha - pa)
    if aov == "pathtracing":
        assert np.sqrt((d ** 2).mean()) < 1e-3
        assert (d > 1e-3).mean() < 1e-3
    else:
        assert (d > 1e-4).mean() < 1e-3
    assert d.max() == 0.0, f"host header / plain max abs {d.max()}"


def _facet_gap_camera(cfg, scene):
    """The eye in the gap between a tessellated sphere and its bound sphere
    (inside mesh j's bound, outside its facets: the d2 <= r2 case of the
    mesh cull with a lit view), looking at the emissive mesh 0 from j, the
    mesh nearest to it."""
    buf = TriangleBuffers.from_scene(scene)
    b = buf.mesh_bounds.numpy().astype(np.float64)
    d = np.linalg.norm(b[:, :3] - b[0, :3], axis=1)
    d[0] = np.inf
    j = int(np.argmin(d))
    soup = {k: v.numpy().astype(np.float64) for k, v in buf.soup.items()}
    mine = soup["mesh_id"] == j
    cen = np.stack([soup[f"v1{a}"] + (soup[f"e1{a}"] + soup[f"e2{a}"]) / 3.0
                    for a in "xyz"], 1)[mine]
    radial = cen - b[j, :3]
    dist = np.linalg.norm(radial, axis=1)
    out = radial / dist[:, None]
    f = int(np.argmax(out @ ((b[0, :3] - b[j, :3]) / d[j])))
    eye = cen[f] + out[f] * 0.5 * (np.sqrt(b[j, 3]) - dist[f])
    assert np.linalg.norm(eye - b[j, :3]) ** 2 < b[j, 3]  # inside the bound
    vm = look_at(eye.astype(np.float32), b[0, :3].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed(), j


@pytest.mark.parametrize("lane_list", [8, 1], ids=["list8", "list1"])
def test_triangle_header_hard_culling(lib, lib_list1, lane_list):
    """The triangle walk with the eye inside a mesh's bound (the culled
    primaries keep that mesh in every tile) against the plain brute-force
    sweep, bit-equal over 2 steps; with a one-entry per-lane list every ray
    that enters two meshes overflows it and walks them in chunks."""
    host = lib if lane_list == 8 else lib_list1
    cfg = TRI_CFG
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count,
                                                 cfg.world_size,
                                                 cfg.scene_seed),
                                 cfg.disc_lat, cfg.disc_long)
    cam, j = _facet_gap_camera(cfg, scene)
    bounds = TriangleBuffers.from_scene(scene).mesh_bounds.T.contiguous()
    table = visibility_table(cfg, bounds, cam,
                             torch.as_tensor(tile_grid(cfg))).numpy()
    assert all(j in row[1:1 + row[0]] for row in table)
    _walk_stats(host)
    ha, _ = _render_triangles(cfg, scene, cam, 2, host_lib=host)
    scans, overflows, longest = _walk_stats(host)
    pa, _ = _render_triangles(cfg, scene, cam, 2)
    assert (pa[:3].max(0) > 0).mean() > 0.05  # a lit frame
    np.testing.assert_array_equal(ha, pa)
    assert scans > 0 and 1 < longest <= lane_list or lane_list == 1
    if lane_list == 1:
        assert longest == 1 and overflows > 0


def test_triangle_header_multi_slab_obj(lib):
    """A 4-torus OBJ scene: 768 triangles per mesh, 6 slabs each, so the
    traversal's slab loop runs past one slab (the default scene has 2)."""
    cfg = RenderConfig(width=128, height=64, tiles_per_step=2,
                       emissive_every=2, scene_kind="triangle").validate()
    scene = load_obj(torus_field_obj(n_tori=4))
    sc = TriangleBuffers.from_scene(scene)
    assert (sc.slab_count.numpy() == 6).all()
    # From the emissive torus 0's side, 2.5 bound radii from the diffuse
    # torus 1, looking at torus 1: a lit frame.
    b = sc.mesh_bounds.numpy().astype(np.float64)
    to_e = (b[0, :3] - b[1, :3]) / np.linalg.norm(b[0, :3] - b[1, :3])
    eye = b[1, :3] + to_e * 2.5 * np.sqrt(b[1, 3])
    vm = look_at(eye.astype(np.float32), b[1, :3].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    ha, _ = _render_triangles(cfg, scene, cam, 2, host_lib=lib)
    pa, _ = _render_triangles(cfg, scene, cam, 2)
    assert (pa[:3].max(0) > 0).mean() > 0.05
    np.testing.assert_array_equal(ha[3], pa[3])
    d = np.abs(ha - pa)
    assert np.sqrt((d ** 2).mean()) < 1e-3
    assert (d > 1e-3).mean() < 1e-3


ASAN_RENDER = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import RNG_CODES, step_params
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import (build_triangle_scene, compute_spheres,
                                 load_obj, torus_field_obj)
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 16
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
    ip, fp = step_params(cfg, cfg.tile_count, m, Camera.from_config(cfg).packed())
    arrays = [ip, fp] + [t.numpy() for t in (
        sched, *buf.kernel_arrays(), accum, output)]
    ptrs = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
    for _ in range(2):
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:14],
                                        None, *ptrs[14:], None) == 0
    assert float(accum[3].sum()) == 2 * cfg.padded_height * cfg.padded_width
print("clean")
"""


ASAN_WAVEFRONT = r"""
import ctypes, sys
import numpy as np
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.pathtrace import wavefront_draw_position
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import compute_spheres
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_wavefront_pass_a_host.argtypes = [p] * 10
lib.l2n_wavefront_pass_b_host.argtypes = [p, p, i, i, i] + [p] * 6
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
cfg = RenderConfig(width=128, height=64, spp_per_step=2,
                   wavefront=True).validate()
cfg = cfg.replace(tiles_per_step=cfg.tile_count)
sched = np.ascontiguousarray(tile_grid(cfg), np.int32)
# 100 spheres: 8 does not divide the scene, so pass B's split sweeps end
# on a partial round
for count in (128, 100):
    spheres = compute_spheres(count).packed().numpy()
    n = cfg.tile_count * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = step_params(cfg, cfg.tile_count, count,
                         Camera.from_config(cfg).packed())
    next_pair, has_spare = wavefront_draw_position(cfg)
    for step in range(2):
        col = np.empty((3, n), np.float32)
        back = np.full((3, n), np.nan, np.float32)
        rays = np.empty((9, n), np.float32)
        meta = np.empty((3, n), np.int32)
        n_alive = np.full(1, -1, np.int32)
        assert lib.l2n_wavefront_pass_a_host(*map(ptr, (
            ip, fp, sched, spheres, accum, col, back, rays, meta,
            n_alive))) == 0
        na = int(n_alive[0])
        assert 0 < na < n, na
        lanes = meta[2, :na]
        # each survivor's lane once, and pass A wrote back at exactly the
        # others
        assert lanes.min() >= 0 and lanes.max() < n
        assert np.unique(lanes).size == na
        dead = np.ones(n, bool)
        dead[lanes] = False
        assert (back[:, dead] == 0).all() and np.isnan(back[:, ~dead]).all()
        for group in (1, 8):
            b = back.copy()
            assert lib.l2n_wavefront_pass_b_host(
                ptr(ip), ptr(fp), group, next_pair, int(has_spare),
                *map(ptr, (n_alive, spheres, rays, meta)), None,
                ptr(b)) == 0
            assert not np.isnan(b).any() and (b[:, dead] == 0).all()
        accum[3] += cfg.spp_per_step
print("clean")
"""


def test_wavefront_header_memcheck_asan(asan_build):
    """The memory check of the wavefront passes: the header built with
    AddressSanitizer runs passes A and B on two whole-frame steps of the
    default 128-sphere scene and of 100 spheres (pass B's groups of 8 end
    on a partial round) at 2 spp, into
    slot and lane arrays of exactly
    n_lanes entries each, so a slot written past n_lanes is caught; every
    lane's back is written exactly once, by pass A (the dead lanes, 0) or by
    pass B (each survivor's lane, which the slots name once)."""
    _asan_render(asan_build, script=ASAN_WAVEFRONT)


def test_triangle_header_memcheck_asan(asan_build):
    """The memory check of the triangle traversal (ROADMAP Queue 3 #4: never
    read a slab past a mesh's count): the header built with
    AddressSanitizer renders the default 128-mesh scene and the multi-slab
    torus field, every device-side read landing in a heap buffer of exactly
    its size, through the culled primaries' lists and the per-lane walk.
    compute-sanitizer, the card's counterpart, does not run on the card's
    machine."""
    _asan_render(asan_build)


def test_triangle_header_memcheck_asan_list_overflow(asan_build):
    """The same memory check with a two-entry per-lane mesh list, so the
    walk's chunked rescans run (ROADMAP Queue 3 #15)."""
    _asan_render(asan_build, "-DL2N_LANE_LIST=2")


def test_triangle_header_memcheck_asan_ambient_occlusion(asan_build):
    """The same memory check for the ambient-occlusion AOV, whose second
    cast walks every mesh with its own bound direction (TriSceneView::
    occluded), with a two-entry per-lane list so that cast's chunked
    rescans run too (ROADMAP Queue 3 #15)."""
    _asan_render(asan_build, "-DL2N_LANE_LIST=2", args=("ambient_occlusion",))


ASAN_ONEHOT = r"""
import ctypes, sys
import numpy as np
import torch
from l2n_tpu_torch.probes import onehot_recovery as oh
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_onehot_split_host.argtypes = [i, i, p, p, i, p, ctypes.c_int64, p]
lib.l2n_onehot_split_host.restype = i
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
# 32 lanes per ray: at 16 spheres half of each group's lanes hold none, at
# 100 the last round is partial
for s in (16, 100):
    x = oh.inputs(s)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    for carry in (1, 0):
        out = np.empty_like(x["rays"])
        assert lib.l2n_onehot_split_host(
            carry, 32, ptr(x["rays"]), ptr(x["spheres"]), s, ptr(x["table"]),
            x["rays"][0].size, ptr(out)) == 0
        want = (oh.onehot_carry_plain(t["rays"], t["spheres"]) if carry
                else oh.onehot_gather_plain(t["rays"], t["spheres"],
                                            t["table"])).numpy()
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
print("clean")
"""


ASAN_SWEEP = r"""
import ctypes, sys
import numpy as np
import torch
from l2n_tpu_torch.probes import sweep_variants as sv
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sweep_chunked_host.argtypes = [i, i, p, p, p, i, ctypes.c_int64, i,
                                       p, p]
lib.l2n_sweep_chunked_host.restype = i
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
data = sv.inputs(blocks=1)
bias = np.zeros((1, 32, 128), np.float32)
# 4 repeats a chunk: 5 repeats leave a remainder chunk of 1, 3 one of 2 and
# one of 1; 100 and 13 spheres end in a partial block of 32, and 13 in the
# sphere loop's remainder
for n, reps in ((100, 5), (13, 3)):
    rows = np.ascontiguousarray(
        np.stack([data[k][:n] for k in ("cx", "cy", "cz", "r2")]))
    for carry in (1, 0):
        out = np.empty_like(bias)
        assert lib.l2n_sweep_chunked_host(
            carry, 4, ptr(data["o"]), ptr(data["d"]), ptr(rows), n,
            bias.size, reps, ptr(bias), ptr(out)) == 0
        plain = sv.sweep_vpu_plain if carry else sv.sweep_vpu2_plain
        want = plain(torch.from_numpy(data["o"]), torch.from_numpy(data["d"]),
                     *(torch.from_numpy(r) for r in rows),
                     torch.from_numpy(bias), reps).numpy()
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
print("clean")
"""


ASAN_MMA = r"""
import ctypes, sys
import numpy as np
import torch
from l2n_tpu_torch.probes import sweep_variants as sv
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sweep_mma_host.argtypes = [i, p, p, p, i, ctypes.c_int64, i, p, p,
                                   p, p, p]
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
data = sv.inputs(blocks=1)
bias = np.zeros((1, 32, 128), np.float32)
# 24 and 120 spheres: what the kernel pads to a tile of 16; every buffer
# exactly sized
for n, reps in ((24, 3), (120, 5)):
    cmat = np.ascontiguousarray(data["cmat"][:, :n])
    out = np.empty_like(bias)
    index = np.empty((reps, 1, 32, 128), np.int32)
    rejected = np.empty((bias.size, n, reps), np.uint8)
    threshold = np.empty((bias.size, n), np.float32)
    lib.l2n_sweep_mma_host(4, ptr(data["o"]), ptr(data["d"]), ptr(cmat), n,
                           bias.size, reps, ptr(bias), ptr(out), ptr(index),
                           ptr(rejected), ptr(threshold))
    want_index = torch.empty((reps, 1, 32, 128), dtype=torch.int32)
    want = sv.sweep_mma_plain(torch.from_numpy(data["o"]),
                              torch.from_numpy(data["d"]),
                              torch.from_numpy(cmat), torch.from_numpy(bias),
                              reps, want_index).numpy()
    assert np.array_equal(out.view(np.int32), want.view(np.int32))
    assert np.array_equal(index, want_index.numpy())
print("clean")
"""


def test_sweep_mma_header_memcheck_asan(asan_build):
    """The memory check of the mma sweep's pieces (ROADMAP Queue 3 #15):
    the header built with AddressSanitizer runs the host sweep over 4,096
    rays at (n, repeats) = (24, 3) and (120, 5), every buffer exactly
    sized, bit-equal to the plain sweep_mma in acc and index."""
    _asan_render(asan_build, script=ASAN_MMA)


def test_sweep_chunked_header_memcheck_asan(asan_build):
    """The memory check of sweep_variants' chunked sweep (ROADMAP Queue 3
    #15): the header built with AddressSanitizer sweeps 4,096 rays over a
    packed buffer of exactly n spheres, 4 repeats a chunk, at (n, repeats)
    = (100, 5) and (13, 3), carry and gather, bit-equal to the plain
    versions: neither the unrolled sphere loop, its remainder, the gather
    nor a remainder chunk reads past the last sphere."""
    _asan_render(asan_build, script=ASAN_SWEEP)


def test_onehot_split_header_memcheck_asan(asan_build):
    """The memory check of onehot_recovery's split sweep (ROADMAP Queue 3
    #15): the header built with AddressSanitizer sweeps 4,096 rays with 32
    lanes per ray over a packed buffer of exactly S spheres and gathers
    from an (S, 8) table of exactly S rows, at S = 16 (lanes 16-31 of
    every group hold no sphere) and S = 100 (a partial last round), carry
    and gather, bit-equal to the plain versions: a lane past the last
    sphere reads none."""
    _asan_render(asan_build, script=ASAN_ONEHOT)


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


def _asan_render(asan_build, *defines, script=ASAN_RENDER, args=()):
    lib_path, asan = asan_build(*defines)
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=str(CSRC.parents[1]))
    proc = subprocess.run([sys.executable, "-c", script, str(lib_path), *args],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


# ---------------------------------------------------------------------------
# The samplers of every rng mode (csrc/pathtrace.cuh) against the plain ones
# ---------------------------------------------------------------------------

TORCH_PHILOX = r"""
#include <ATen/core/PhiloxRNGEngine.h>
#include <cstdint>
// Rows of kc: key k0, k1, counter c0..c3. at::Philox4_32(seed, subsequence,
// offset) keys with seed = k1:k0 and counts from (offset = c1:c0,
// subsequence = c3:c2); its four draws are the block's words.
extern "C" void l2n_torch_philox(const uint32_t* kc, uint32_t* out,
                                 int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t* r = kc + 6 * i;
    at::Philox4_32 e(r[0] | (uint64_t(r[1]) << 32),
                     r[4] | (uint64_t(r[5]) << 32),
                     r[2] | (uint64_t(r[3]) << 32));
    for (int w = 0; w < 4; ++w) out[4 * i + w] = e();
  }
}
"""


@pytest.fixture(scope="module")
def torch_philox(tmp_path_factory):
    """torch's own Philox4x32-10 (ATen/core/PhiloxRNGEngine.h, shipped in
    the wheel's include directory), built with g++."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    include = Path(torch.__file__).resolve().parent / "include"
    if cxx is None or not (include / "ATen/core/PhiloxRNGEngine.h").is_file():
        pytest.skip("no C++ compiler or no ATen headers")
    d = tmp_path_factory.mktemp("torch_philox")
    (d / "philox.cpp").write_text(TORCH_PHILOX)
    out = d / "libtorch_philox.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{include}", str(d / "philox.cpp"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.l2n_torch_philox.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    return lib


def test_philox_matches_torch_and_header(lib, torch_philox):
    """The plain Philox4x32-10 (rng/philox.py) equals torch's
    at::Philox4_32 and the header's philox4x32_10 on 10^5 random (key,
    counter) pairs, and gives Random123's known answer for key 0, counter
    0."""
    gen = np.random.Generator(np.random.PCG64(23))
    kc = gen.integers(0, 2**32, (100_000, 6), dtype=np.uint32)
    kc[0] = 0
    want = np.empty((kc.shape[0], 4), np.uint32)
    torch_philox.l2n_torch_philox(_ptr(kc), _ptr(want), kc.shape[0])
    assert want[0].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                0x9B00DBD8]
    t = [torch.from_numpy(kc[:, i].astype(np.int64)) for i in range(6)]
    got = philox.philox4x32(t[0], t[1], *t[2:])
    np.testing.assert_array_equal(
        np.stack([g.numpy() for g in got], 1), want.astype(np.int64))
    # The header, one key for all lanes (the samplers' use).
    ctr = np.ascontiguousarray(kc[:, 2:].T)
    head = np.empty_like(ctr)
    lib.l2n_philox_host(kc[1, 0], kc[1, 1], _ptr(ctr), _ptr(head),
                        ctr.shape[1])
    got = philox.philox4x32(int(kc[1, 0]), int(kc[1, 1]),
                            *(torch.from_numpy(c.astype(np.int64))
                              for c in ctr))
    np.testing.assert_array_equal(head.astype(np.int64),
                                  np.stack([g.numpy() for g in got]))


def _philox_bits_host(lib, k, h):
    """(out, writes) of the raw-bits kernel's block mapping at (k, h)."""
    out = np.zeros((k, h, 128), np.uint32)
    writes = np.zeros((k, h, 128), np.int32)
    lib.l2n_philox_bits_host(0xBEEF, 7, k, h, _ptr(out), _ptr(writes))
    return out, writes


def test_philox_bits_header_matches_plain(lib):
    out, writes = _philox_bits_host(lib, 4, 256)
    want = philox_bits_plain(torch.tensor([0xBEEF, 7], dtype=torch.int32))
    assert (writes == 1).all()
    np.testing.assert_array_equal(out.view(np.int32), want.numpy())


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg"])
def test_stateful_sampler_header_matches_plain(lib, mode):
    """12 draw1s of 8,192 per-pixel streams: values and stepped states."""
    if mode == "tinymt":
        status, params = init_tinymt_states(64, 128, 3)
        words = list(status) + list(params)
    else:
        words = list(init_tauslcg_states(64, 128, 3))
    planes = np.ascontiguousarray(
        np.stack([w.reshape(-1).numpy() for w in words]).astype(np.uint32))
    n, draws = planes.shape[1], 12
    out = np.empty((draws, n), np.float32)
    lib.l2n_stateful_draws_host(RNG_CODES[mode], _ptr(planes), n, draws,
                                _ptr(out))
    state = tuple(w.reshape(-1) for w in words[:4])
    for d in range(draws):
        if mode == "tinymt":
            v, state = tinymt.generate_float_oo(
                state, tuple(w.reshape(-1) for w in words[4:7]))
        else:
            v, state = tauslcg.rand1(state)
        np.testing.assert_array_equal(out[d].view(np.uint32),
                                      v.numpy().view(np.uint32))
    for i in range(4):
        np.testing.assert_array_equal(planes[i].astype(np.int64),
                                      state[i].numpy())


@pytest.mark.parametrize("mode", ["tpu_hw", "tinymt", "tauslcg"])
def test_header_matches_plain_step_every_rng(lib, mode):
    """The per-pixel path body with each sampler against the plain step on
    the aimed config, 3 steps of 2 samples. The gates of
    test_header_matches_plain_step; for the stateful modes the state planes
    too: bit-equal except where the C library's sinf/cosf and torch's
    vectorised CPU ones (an ulp or two apart) flip a path's decision, and
    with it that pixel's draw count (on the card nvcc's and torch's are the
    same functions, and chip_smoke.py expects bit-equal planes)."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, spp_per_step=2, rng=mode).validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    ha, ho, hs = _render(cfg, cam, 3, host_lib=lib, with_state=True)
    pa, po, ps = _render(cfg, cam, 3, with_state=True)
    assert (pa[:3].max(0) > 0).mean() > 0.3  # a lit frame
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3
    if mode != "tpu_hw":
        assert not torch.equal(ps, init_rng_state(cfg))
        assert (hs != ps).any(0).float().mean() < 2e-3


@pytest.mark.parametrize("mode", ["threefry", "tpu_hw", "tinymt", "tauslcg"])
def test_ao_header_matches_plain_step_every_rng(lib, mode):
    """The ambient-occlusion AOV in every rng mode, 3 steps of 2 samples:
    only a hit draws, so a miss lane's TinyMT/TausLCG state stays where it
    was; accum and the state planes bit-equal."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, spp_per_step=2, rng=mode,
                       aov="ambient_occlusion").validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    ha, _, hs = _render(cfg, cam, 3, host_lib=lib, with_state=True)
    pa, _, ps = _render(cfg, cam, 3, with_state=True)
    np.testing.assert_array_equal(ha, pa)
    assert 0 < (pa[0] > 0).mean() < (pa[3] > 0).mean()
    if hs is not None:
        np.testing.assert_array_equal(hs.numpy(), ps.numpy())
        assert not torch.equal(ps, init_rng_state(cfg))


def test_triangle_header_matches_plain_step_tinymt(lib):
    """The triangle traversal with the TinyMT sampler, 2 steps: accum and
    the state planes bit-equal (tests/test_kernels.py:125-151's gates)."""
    _triangle_host_vs_plain_with_state(lib, TRI_CFG.replace(rng="tinymt"))


def test_triangle_ao_header_matches_plain_step_tauslcg(lib):
    """The ambient-occlusion AOV on meshes with the TausLCG sampler (only a
    hit draws), 2 steps: accum and the state planes bit-equal."""
    _triangle_host_vs_plain_with_state(
        lib, TRI_CFG.replace(rng="tauslcg", aov="ambient_occlusion"))


def _triangle_host_vs_plain_with_state(lib, cfg):
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count,
                                                 cfg.world_size,
                                                 cfg.scene_seed),
                                 cfg.disc_lat, cfg.disc_long)
    cam = _tri_aimed_camera(cfg).packed()
    buf = TriangleBuffers.from_scene(scene)
    tiles = torch.as_tensor(tile_grid(cfg))
    k = cfg.effective_tiles_per_step
    frames = []
    for host in (True, False):
        accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
        output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
        planes = init_rng_state(cfg)
        for i in range(2):
            sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
            if not host:
                triangle_pt_plain(cfg, sched, cam, buf, accum, output, planes)
                continue
            m, s = buf.slab_bounds.shape[:2]
            ip, fp = step_params(cfg, k, m, cam)
            arrays = [sched, *buf.kernel_arrays()]
            assert lib.l2n_triangle_pt_host(
                _ptr(ip), _ptr(fp), s, s * 128,
                *(_ptr(a.numpy()) for a in arrays), None,
                *(_ptr(a.numpy()) for a in (accum, output, planes))) == 0
        frames.append((accum.numpy(), planes.numpy()))
    (ha, hs), (pa, ps) = frames
    assert (pa[:3].max(0) > 0).mean() > 0.05
    np.testing.assert_array_equal(ha, pa)
    np.testing.assert_array_equal(hs, ps)
    assert (ps != init_rng_state(cfg).numpy()).any()


# ---------------------------------------------------------------------------
# The probes' per-lane bodies (csrc/sweep_probe.cuh) against the plain ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [True, False], ids=["vpu", "vpu2"])
def test_sweep_probe_header_matches_plain(lib, carry):
    """sweep_variants' lane body over one block (4,096 random rays), 16
    spheres of the default scene, 3 repeats from a random bias: bit-equal
    to the plain sweep_vpu / sweep_vpu2."""
    data = sweep_variants.inputs(blocks=1)
    o, d = data["o"], data["d"]
    rows = np.ascontiguousarray(
        np.stack([data[k][:16] for k in ("cx", "cy", "cz", "r2")]))
    bias = np.random.default_rng(24).uniform(
        -1, 1, (1, 32, 128)).astype(np.float32)
    out = np.empty_like(bias)
    lib.l2n_sweep_lanes_host(int(carry), _ptr(o), _ptr(d), _ptr(rows), 16,
                             bias.size, 3, _ptr(bias), _ptr(out))
    plain = (sweep_variants.sweep_vpu_plain if carry
             else sweep_variants.sweep_vpu2_plain)
    want = plain(torch.from_numpy(o), torch.from_numpy(d),
                 *(torch.from_numpy(r) for r in rows),
                 torch.from_numpy(bias), 3).numpy()
    assert (want > bias).mean() > 0.01  # some lanes hit
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@functools.cache
def _sweep_plain(carry, n, repeats, tied=False):
    """sweep_variants' inputs for one block (4,096 rays) at n spheres of the
    default scene, a random bias, and the plain sweep_vpu / sweep_vpu2 over
    `repeats` repeats. `tied`: the first n // 2 spheres each twice, at
    indices 2j and 2j + 1, so that every hit is a tie in t."""
    data = sweep_variants.inputs(blocks=1)
    rows = np.stack([data[k][:n] for k in ("cx", "cy", "cz", "r2")])
    if tied:
        rows = np.repeat(rows[:, :n // 2], 2, axis=1)
    rows = np.ascontiguousarray(rows)
    bias = np.random.default_rng(24).uniform(
        -1, 1, (1, 32, 128)).astype(np.float32)
    plain = (sweep_variants.sweep_vpu_plain if carry
             else sweep_variants.sweep_vpu2_plain)
    want = plain(torch.from_numpy(data["o"]), torch.from_numpy(data["d"]),
                 *(torch.from_numpy(r) for r in rows),
                 torch.from_numpy(bias), repeats).numpy()
    return data["o"], data["d"], rows, bias, want


def _sweep_chunked(lib, carry, chunk, o, d, rows, bias, repeats):
    out = np.empty_like(bias)
    assert lib.l2n_sweep_chunked_host(
        int(carry), chunk, _ptr(o), _ptr(d), _ptr(rows), rows.shape[1],
        bias.size, repeats, _ptr(bias), _ptr(out)) == 0
    return out


@pytest.mark.parametrize("n,repeats", [(16, 3), (100, 5), (128, 16),
                                       (13, 3)])
@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
@pytest.mark.parametrize("carry", [True, False], ids=["vpu", "vpu2"])
def test_sweep_chunked_header_matches_plain(lib, carry, chunk, n, repeats):
    """The kernels' chunked lane body (csrc/sweep_probe.cuh
    `sweep_lane_chunked`: spheres outside, `chunk` repeats inside, packed
    spheres in blocks of 32, the roots only for the spheres a ray meets in
    a repeat of the chunk) over one block of 4,096 rays: bit-equal to the
    plain sweep_vpu / sweep_vpu2 (the kernels run 4 and 8 repeats a
    chunk). 4, 8 and 16 do not divide 3 or 5 repeats (remainder chunks),
    32 does not divide 100 or 13 (a partial block), and the sphere loop's
    unroll does not divide 13."""
    o, d, rows, bias, want = _sweep_plain(carry, n, repeats)
    out = _sweep_chunked(lib, carry, chunk, o, d, rows, bias, repeats)
    assert (want > bias).mean() > 0.01  # some lanes hit
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("carry", [True, False], ids=["vpu", "vpu2"])
def test_sweep_chunked_header_tie_rule(lib, carry, chunk):
    """Every sphere twice, at indices 2j and 2j + 1: every hit is a tie in
    t, and each repeat of a chunk keeps the smaller index, as the serial
    sweep does (bit-equal to the plain versions, whose accumulation adds
    the winner's index / 1000 in every repeat)."""
    o, d, rows, bias, want = _sweep_plain(carry, 64, 5, tied=True)
    out = _sweep_chunked(lib, carry, chunk, o, d, rows, bias, 5)
    assert (want > bias).mean() > 0.01
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("carry", [True, False], ids=["carry", "gather"])
def test_onehot_probe_header_matches_plain(lib, carry):
    """onehot_recovery's lane body over its 4,096 rays and 16 spheres:
    all six planes bit-equal to the plain onehot_carry / onehot_gather
    (misses included: r2 = 1 for the carry, 0 for the gather)."""
    x = onehot_recovery.inputs(16)
    out = np.empty_like(x["rays"])
    lib.l2n_onehot_lanes_host(int(carry), _ptr(x["rays"]), _ptr(x["spheres"]),
                              16, _ptr(x["table"]), 32 * 128, _ptr(out))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = (onehot_recovery.onehot_carry_plain(t["rays"], t["spheres"])
            if carry else onehot_recovery.onehot_gather_plain(
                t["rays"], t["spheres"], t["table"])).numpy()
    assert 0.01 < (want[1] >= 0).mean() < 0.99
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@functools.cache
def _onehot_plain(carry, s, tied=False):
    """onehot_recovery's inputs at s spheres and the plain carry or gather
    output. `tied`: the first s // 2 spheres each twice, at indices 2j and
    2j + 1, so that every hit ties across two of a group's parts."""
    x = onehot_recovery.inputs(s)
    if tied:
        x["spheres"] = np.ascontiguousarray(
            np.repeat(x["spheres"][:, :s // 2], 2, axis=1))
        x["table"][:, :4] = x["spheres"].T
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = (onehot_recovery.onehot_carry_plain(t["rays"], t["spheres"])
            if carry else onehot_recovery.onehot_gather_plain(
                t["rays"], t["spheres"], t["table"])).numpy()
    return x, want


def _onehot_split(lib, carry, group, x):
    out = np.empty_like(x["rays"])
    s = x["spheres"].shape[1]
    assert lib.l2n_onehot_split_host(
        int(carry), group, _ptr(x["rays"]), _ptr(x["spheres"]), s,
        _ptr(x["table"]), 32 * 128, _ptr(out)) == 0
    return out


@pytest.mark.parametrize("s", [16, 100, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("carry", [True, False], ids=["carry", "gather"])
def test_onehot_split_header_matches_plain(lib, carry, group, s):
    """The kernels' split sweep (csrc/sweep_probe.cuh `split_sweep`, G
    lanes per ray, packed spheres, sqrt only on a real discriminant, the
    gather's one 16-byte row load) over the probe's 4,096 rays: all six
    planes bit-equal to the plain onehot_carry / onehot_gather, misses
    included (r2 = 1 for the carry, 0 for the gather); G = 8 and 32 do not
    divide 100, G = 32 exceeds 16."""
    x, want = _onehot_plain(carry, s)
    out = _onehot_split(lib, carry, group, x)
    assert 0.01 < (want[1] >= 0).mean() < 0.99
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("carry", [True, False], ids=["carry", "gather"])
def test_onehot_split_header_tie_rule(lib, carry, group):
    """Every sphere twice, at indices 2j and 2j + 1, which lie in two parts
    of a group for G >= 2: every hit is a tie in t, and the split sweep
    keeps the smaller index, as the serial sweep does (bit-equal to the
    plain versions, every winner's index even)."""
    x, want = _onehot_plain(carry, 64, tied=True)
    out = _onehot_split(lib, carry, group, x)
    hit = want[1] >= 0
    assert hit.mean() > 0.01 and (want[1][hit] % 2 == 0).all()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))



# ---------------------------------------------------------------------------
# sweep_variants' tensor-core sweep: the pieces of csrc/sweep_probe.cuh the
# kernel runs (slots, c, miss threshold, exact resolve, winner key, row),
# the tensor cores' sums emulated in five orders and roundings
# ---------------------------------------------------------------------------

MMA_MODES = {"order": 0, "reversed": 1, "pairwise": 2, "truncated": 3,
             "aligned": 4}


@functools.cache
def _mma_plain(n, repeats, tied=False):
    """sweep_variants' inputs for one block (4,096 rays) at n spheres of the
    default scene (`tied`: the first n // 2 each twice, at 2j and 2j + 1),
    a random bias, and the plain sweep_mma's acc and index."""
    data = sweep_variants.inputs(blocks=1)
    cmat = data["cmat"][:, :n]
    if tied:
        cmat = np.repeat(cmat[:, :n // 2], 2, axis=1)
    cmat = np.ascontiguousarray(cmat)
    bias = np.random.default_rng(24).uniform(
        -1, 1, (1, 32, 128)).astype(np.float32)
    index = torch.empty((repeats, 1, 32, 128), dtype=torch.int32)
    want = sweep_variants.sweep_mma_plain(
        torch.from_numpy(data["o"]), torch.from_numpy(data["d"]),
        torch.from_numpy(cmat), torch.from_numpy(bias), repeats,
        index).numpy()
    return data["o"], data["d"], cmat, bias, want, index.numpy()


def _mma_host(lib, mode, o, d, cmat, bias, repeats):
    """The host sweep's (acc, index, rejected (lanes, n, repeats),
    threshold (lanes, n))."""
    n = cmat.shape[1]
    out = np.empty_like(bias)
    index = np.empty((repeats, *bias.shape), np.int32)
    rejected = np.empty((bias.size, n, repeats), np.uint8)
    threshold = np.empty((bias.size, n), np.float32)
    lib.l2n_sweep_mma_host(mode, _ptr(o), _ptr(d), _ptr(cmat), n, bias.size,
                           repeats, _ptr(bias), _ptr(out), _ptr(index),
                           _ptr(rejected), _ptr(threshold))
    return out, index, rejected.astype(bool), threshold


def _mma_discriminants(o, d, cmat, repeats):
    """(repeats, n, lanes) hb^2 - c and (n, lanes) c of the plain sweep_mma's
    algebra, in its arithmetic (probes/sweep_variants.py sweep_mma_plain)."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    n = cmat.shape[1]
    col = lambda k: torch.from_numpy(cmat[k]).view(n, 1, 1, 1)  # noqa: E731
    centre = (col(0), col(1), col(2))
    ox, oy, oz = o
    oo = ox * ox + oy * oy + oz * oz
    c = oo - (sweep_variants._dot(centre, ox, oy, oz, True) * 2) + col(4)
    discs = []
    for r in range(repeats):
        dx = d[0] * sweep_variants._scale(r, o.device)
        od = ox * dx + oy * d[1] + oz * d[2]
        hb = od - sweep_variants._dot(centre, dx, d[1], d[2], True)
        discs.append((hb * hb - c).reshape(n, -1))
    return torch.stack(discs).numpy(), c.reshape(n, -1).numpy()


@pytest.mark.parametrize("n,repeats", [(8, 1), (8, 3), (8, 16), (24, 1),
                                       (24, 3), (24, 16), (128, 1),
                                       (128, 3), (128, 16)])
@pytest.mark.parametrize("mode", list(MMA_MODES.values()),
                         ids=list(MMA_MODES))
def test_sweep_mma_header_matches_plain(lib, mode, n, repeats):
    """The mma sweep's per-pair pieces (csrc/sweep_probe.cuh: the 3xTF32
    slots, c and the miss threshold once per (lane, sphere), |D| < T per
    repeat, the exact resolve of the rest, the (t, index) key, the row)
    over one block of 4,096 rays, the tensor cores' sums emulated in
    order, reversed, pairwise, truncating and aligned-and-truncated:
    bit-equal to the plain sweep_mma, acc and every repeat's index. n = 24
    is not a multiple of 16 (the kernel pads its last sphere tile)."""
    o, d, cmat, bias, want, want_index = _mma_plain(n, repeats)
    out, index, rejected, _ = _mma_host(lib, mode, o, d, cmat, bias, repeats)
    assert (want_index >= 0).mean() > 0.01  # some lanes hit
    assert rejected.mean() > 0.99  # the test rejects nearly every pair
    np.testing.assert_array_equal(index, want_index)
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mode", list(MMA_MODES.values()),
                         ids=list(MMA_MODES))
def test_sweep_mma_header_tie_rule(lib, mode):
    """Every sphere twice, at indices 2j and 2j + 1: every hit is a tie in
    t, and the key keeps the smaller index in every repeat, as the plain
    version does (bit-equal, acc and index)."""
    o, d, cmat, bias, want, want_index = _mma_plain(64, 5, tied=True)
    out, index, _, _ = _mma_host(lib, mode, o, d, cmat, bias, 5)
    assert (want_index >= 0).mean() > 0.01
    assert (want_index[want_index >= 0] % 2 == 0).all()
    np.testing.assert_array_equal(index, want_index)
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@functools.cache
def _grazing_rays(repeats=3, seed=7):
    """4,096 rays (one block) whose lines pass sphere p % 8 of 8 large
    spheres of the default scene at a distance whose square is r^2 - u,
    u ~ U(-30, 30) on two thirds of them and U(-1, 1) on the rest: hb^2 - c
    lies within the miss test's margin (about +-18 here) for many pairs.
    Returns (o, d, cmat, bias) and the plain sweep_mma's (acc, index)."""
    data = sweep_variants.inputs(blocks=1)
    pick = np.flatnonzero(data["r2"] > 100.0)[:8]
    cmat = np.ascontiguousarray(data["cmat"][:, pick])
    rng = np.random.default_rng(seed)
    lanes = 32 * 128
    j = np.arange(lanes) % 8
    centre = cmat[:3, j].T.astype(np.float64)
    r2 = cmat[3, j].astype(np.float64)
    o = rng.uniform(-400, 400, (lanes, 3))
    w = centre - o
    dist = np.linalg.norm(w, axis=1, keepdims=True)
    far = np.maximum(1.0, 4.0 * np.sqrt(r2)[:, None] / dist)
    o = centre - w * far  # at least 4 radii from the centre
    w = centre - o
    length = np.linalg.norm(w, axis=1)
    v = rng.normal(size=(lanes, 3))
    v -= (np.sum(v * w, axis=1) / length ** 2)[:, None] * w
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    u = np.where(np.arange(lanes) % 3 == 0, rng.uniform(-1, 1, lanes),
                 rng.uniform(-30, 30, lanes))
    rho = np.sqrt(r2 - u)
    s = rho * length / np.sqrt(length ** 2 - rho ** 2)
    dvec = w + s[:, None] * v
    dvec /= np.linalg.norm(dvec, axis=1, keepdims=True)
    o32 = np.ascontiguousarray(o.T.reshape(3, 1, 32, 128).astype(np.float32))
    d32 = np.ascontiguousarray(
        dvec.T.reshape(3, 1, 32, 128).astype(np.float32))
    bias = np.zeros((1, 32, 128), np.float32)
    index = torch.empty((repeats, 1, 32, 128), dtype=torch.int32)
    want = sweep_variants.sweep_mma_plain(
        torch.from_numpy(o32), torch.from_numpy(d32), torch.from_numpy(cmat),
        torch.from_numpy(bias), repeats, index).numpy()
    return o32, d32, cmat, bias, want, index.numpy()


@pytest.mark.parametrize("mode", list(MMA_MODES.values()),
                         ids=list(MMA_MODES))
def test_sweep_mma_header_margin_adversarial(lib, mode):
    """Grazing rays (`_grazing_rays`): hb^2 - c falls inside the margin's
    band (c - T^2 in the discriminant's units) for most of each ray's
    target pairs, and on both sides of zero. The miss test never rejects a
    candidate whose discriminant is >= 0 in the plain version's arithmetic
    (which would take its roots), and the sweep stays bit-equal to the
    plain sweep_mma."""
    repeats = 3
    o, d, cmat, bias, want, want_index = _grazing_rays(repeats)
    out, index, rejected, threshold = _mma_host(lib, mode, o, d, cmat, bias,
                                                repeats)
    disc, c = _mma_discriminants(o, d, cmat, repeats)  # (R, n, L), (n, L)
    kept = disc >= 0  # the plain version takes these roots
    assert not (rejected.transpose(2, 1, 0) & kept).any()
    band = c - np.maximum(threshold.T, 0.0) ** 2  # (n, L)
    lanes = np.arange(c.shape[1])
    target = (lanes % 8, lanes)
    inside = np.abs(disc[0][target]) <= band[target]
    assert inside.mean() > 0.5
    assert kept[0][target][inside].mean() > 0.2
    assert (~kept[0][target][inside]).mean() > 0.2
    np.testing.assert_array_equal(index, want_index)
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k,h", [(1, 1), (3, 33), (5, 7), (9, 2)])
def test_philox_blocks_header_matches_plain(lib, k, h):
    """philox_bits' kernel mapping (csrc/pathtrace.cuh philox_bits_slot:
    one Philox block per (lane, block), its words to draws 4 block ..
    4 block + 3, fewer for the last block of a k that is not a multiple of
    4) at shapes beside test_philox_bits_header_matches_plain's (4, 256):
    every word of the (k, h, 128) output written once and bit-equal to
    philox_bits_plain."""
    out, writes = _philox_bits_host(lib, k, h)
    want = philox_bits_plain(torch.tensor([0xBEEF, 7], dtype=torch.int32),
                             k, h)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out.view(np.int32), want.numpy())


# ---------------------------------------------------------------------------
# The material modes, the bump and the explicit lights (csrc/brdf.cuh,
# csrc/pathtrace.cuh scatter_materials / explicit_lights)
# ---------------------------------------------------------------------------

# tests/test_tpu_hw.py's explicit-light buffers: two Phong albedos, a point
# light at the origin, a directional light.
LIGHT_BUFFERS = dict(
    diffuse=np.array([[0.9, 0.2, 0.2, 1.0], [0.2, 0.9, 0.2, 1.0]],
                     np.float32),
    point=(np.zeros((1, 3), np.float32),
           np.array([[5e7, 4e7, 3e7]], np.float32)),
    directional=(np.array([[0.3, -1.0, 0.2]], np.float32),
                 np.array([[0.5, 0.5, 0.6]], np.float32)))


def _explicit_lights(phong=True):
    from l2n_tpu_torch.ops.lights import ExplicitLights
    from l2n_tpu_torch.scene.materials import (
        DirectionalLights,
        PhongMaterials,
        PointLights,
    )
    b = LIGHT_BUFFERS
    mats = PhongMaterials.from_arrays(
        b["diffuse"], np.zeros((2, 3), np.float32),
        np.zeros(2, np.float32)) if phong else None
    return ExplicitLights(mats, PointLights.from_arrays(*b["point"]),
                          DirectionalLights.from_arrays(*b["directional"]))


def _brdf_lanes(n=4096, seed=21):
    """Lanes of (n, wo, wi, kd, material rows): unit normals, wo in the
    upper hemisphere (some grazing), wi anywhere (a third below the
    horizon, some grazing); roughness in {0.1, 0.4, 1.0} and random,
    metallic in {0, 1} and random, the other channels random."""
    gen = np.random.Generator(np.random.PCG64(seed))

    def unit(k):
        v = gen.normal(size=(3, k))
        return v / np.linalg.norm(v, axis=0)

    nv = unit(n)
    wo = unit(n)
    wo *= np.sign((wo * nv).sum(0))
    wi = unit(n)
    graze = np.arange(n) % 7 == 0  # wi and wo nearly in the tangent plane
    for w in (wo, wi):
        t = w - (w * nv).sum(0) * nv
        t /= np.linalg.norm(t, axis=0)
        w[:, graze] = (t + 1e-3 * nv)[:, graze]
        w /= np.linalg.norm(w, axis=0)
    mat = gen.random((6, n))
    mat[0] = np.choose(np.arange(n) % 4, [0.1, 0.4, 1.0, mat[0]])
    mat[1] = np.choose(np.arange(n) // 4 % 3, [0.0, 1.0, mat[1]])
    kd = gen.random((3, n))
    f = np.float32
    return tuple(np.ascontiguousarray(a, f) for a in (nv, wo, wi, kd, mat))


def _libm_trig_agrees(x64) -> np.ndarray:
    """Where the C library's sinf and cosf of float32(x) equal torch's
    (the host build's and the plain CPU path's transcendentals)."""
    libm = ctypes.CDLL("libm.so.6")
    for name in ("sinf", "cosf"):
        getattr(libm, name).argtypes = [ctypes.c_float]
        getattr(libm, name).restype = ctypes.c_float
    x = np.asarray(x64, np.float32)
    t = torch.from_numpy(x)
    c_sin = np.array([libm.sinf(v) for v in x.tolist()], np.float32)
    c_cos = np.array([libm.cosf(v) for v in x.tolist()], np.float32)
    return (c_sin == torch.sin(t).numpy()) & (c_cos == torch.cos(t).numpy())


@pytest.mark.parametrize("mode", ["microfacet", "disney"])
def test_brdf_header_matches_plain(lib, mode):
    """csrc/brdf.cuh's eval and sample of each material mode against
    maths/brdf.py on lanes with roughness 0.1, 0.4, 1.0 and metallic 0, 1,
    grazing angles and directions below the horizon (f and pdf 0 there).
    eval takes no transcendental: bit-equal. sample takes the C library's
    sinf/cosf against torch's: bit-equal where those agree on the azimuth,
    elsewhere directions within 1e-6, pdf and weight within 1e-3 relative
    (the card's nvcc and torch share those functions, and chip_smoke.py
    holds them to max abs 0)."""
    from l2n_tpu_torch.maths.brdf import (
        eval_brdf,
        eval_disney,
        sample_brdf,
        sample_disney,
    )
    from l2n_tpu_torch.maths.sampling import frame_z
    from l2n_tpu_torch.ops.kernels.common import MATERIAL_CODES
    nv, wo, wi, kd, mat = _brdf_lanes()
    n = nv.shape[1]
    code = MATERIAL_CODES[mode]
    t = [tuple(torch.from_numpy(a[c]) for c in range(3))
         for a in (nv, wo, wi, kd)]
    m = [torch.from_numpy(mat[c]) for c in range(6)]
    if mode == "disney":
        want = eval_disney(*t, m[0], *m[1:5])
    else:
        want = eval_brdf(*t, m[0])
    f = np.empty((3, n), np.float32)
    pdf = np.empty(n, np.float32)
    lib.l2n_eval_material_host(code, *map(_ptr, (nv, wo, wi, kd, mat)), n,
                               _ptr(f), _ptr(pdf))
    np.testing.assert_array_equal(f, torch.stack(want[:3]).numpy())
    np.testing.assert_array_equal(pdf, want[3].numpy())
    below = (nv * wi).sum(0) <= 0
    assert below.mean() > 0.3 and (pdf[below] == 0).all()
    assert (pdf[~below] > 0).mean() > 0.99

    gen = np.random.Generator(np.random.PCG64(22))
    u = gen.random((3, n), dtype=np.float32)
    ut = [torch.from_numpy(u[c]) for c in range(3)]
    frame = frame_z(*t[0])
    if mode == "disney":
        wwi, ww, wpdf = sample_disney(*ut, t[0], frame, t[1], t[3], m[0],
                                      *m[1:5])
    else:
        wwi, ww, wpdf = sample_brdf(*ut, t[0], frame, t[1], t[3], m[0])
    gwi, gw = np.empty((3, n), np.float32), np.empty((3, n), np.float32)
    gpdf = np.empty(n, np.float32)
    lib.l2n_sample_material_host(code, *map(_ptr, (u, nv, wo, kd, mat)), n,
                                 _ptr(gwi), _ptr(gw), _ptr(gpdf))
    # Bit-equal on the lanes where the C library's sinf and cosf of the
    # azimuth equal torch's; elsewhere within an ulp's consequences (the
    # GGX pdf at roughness 0.1 is steep: up to ~1.3e-4 relative).
    same = _libm_trig_agrees((2.0 * np.pi) * u[2])
    assert same.mean() > 0.9
    for got, want in ((gwi, torch.stack(wwi)), (gw, torch.stack(ww)),
                      (gpdf, wpdf)):
        np.testing.assert_array_equal(got[..., same], want.numpy()[..., same])
    np.testing.assert_allclose(gwi, torch.stack(wwi).numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gpdf, wpdf.numpy(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(gw, torch.stack(ww).numpy(), rtol=1e-3,
                               atol=1e-6)
    assert (gpdf > 0).mean() > 0.5 and np.isfinite(gw).all()


def test_bump_header_matches_plain(lib):
    """csrc/brdf.cuh's perturb_normal against maths/bump.py: unit results
    within 1e-6 of the plain ones (the C library's cosf against torch's),
    normals of any length on entry."""
    from l2n_tpu_torch.maths.bump import perturb_normal
    gen = np.random.Generator(np.random.PCG64(23))
    n = 4096
    pts = (gen.random((3, n)) * 1024 - 512).astype(np.float32)
    nv = (gen.normal(size=(3, n)) * gen.random(n) * 3).astype(np.float32)
    bump = (0.25 + 0.75 * gen.random(n)).astype(np.float32)
    cfg = RenderConfig(normal_map=0.8, normal_map_freq=0.35).validate()
    ip, fp = step_params(cfg, 1, 1, np.zeros((10, 4), np.float32))
    out = np.empty((3, n), np.float32)
    lib.l2n_perturb_normal_host(_ptr(ip), _ptr(fp), _ptr(bump), _ptr(pts),
                                _ptr(nv), n, _ptr(out))
    want = torch.stack(perturb_normal(
        cfg, torch.from_numpy(bump), tuple(torch.from_numpy(pts)),
        tuple(torch.from_numpy(nv)))).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out, axis=0), 1.0, atol=1e-6)
    unbumped = nv / np.linalg.norm(nv, axis=0)
    assert np.abs(out - unbumped).max() > 0.1


def test_explicit_lights_header_matches_plain(lib):
    """csrc/pathtrace.cuh's light loop (a nearest-hit shadow cast per light
    over the sphere scene, Lambert's kd / pi) against
    ops/lights.explicit_light_contribution on vertices on the spheres'
    surfaces, some of whose lights are occluded: bit-equal (no
    transcendental), with both lit and shadowed lanes."""
    from l2n_tpu_torch.ops.lights import explicit_light_contribution
    from l2n_tpu_torch.ops.scenes import sphere_intersector
    cfg = RenderConfig(sphere_count=128).validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    gen = np.random.Generator(np.random.PCG64(24))
    n = 4096
    idx = gen.integers(0, 128, n)
    nv = gen.normal(size=(3, n))
    nv /= np.linalg.norm(nv, axis=0)
    c = spheres[:3].numpy()[:, idx].astype(np.float64)
    h = (c + nv * np.sqrt(spheres[3].numpy()[idx])).astype(np.float32)
    nv = nv.astype(np.float32)
    kd = gen.random((3, n), dtype=np.float32)
    tp = gen.random((3, n), dtype=np.float32)
    lights = _explicit_lights()
    ip, fp = step_params(cfg, 1, sc.count, np.zeros((10, 4), np.float32),
                         lights)
    col = np.zeros((3, n), np.float32)
    rows = lights.buffer("cpu").numpy()
    lib.l2n_explicit_lights_host(_ptr(ip), _ptr(fp),
                                 _ptr(spheres.numpy()), _ptr(rows),
                                 *map(_ptr, (h, nv, kd, tp)), n, _ptr(col))
    intersect = sphere_intersector(*spheres[:4])
    want = explicit_light_contribution(
        cfg, lights, intersect, tuple(torch.from_numpy(h)),
        tuple(torch.from_numpy(nv)), tuple(torch.from_numpy(kd)),
        tuple(torch.from_numpy(tp)))
    np.testing.assert_array_equal(col, torch.stack(want).numpy())
    lit = col.max(0) > 0
    assert 0.1 < lit.mean() < 0.9


MATERIAL_CASES = {
    "microfacet": {"material_mode": "microfacet"},
    "disney": {"material_mode": "disney"},
    "bump": {"normal_map": 0.8},
    "bump_microfacet": {"normal_map": 0.8, "material_mode": "microfacet"},
    "normal_aov_bump": {"normal_map": 0.8, "aov": "normal"},
    "microfacet_fast_math": {"material_mode": "microfacet",
                             "fast_math": True},
    "disney_bump_tpu_hw": {"material_mode": "disney", "normal_map": 0.8,
                           "rng": "tpu_hw"},
    "microfacet_tinymt": {"material_mode": "microfacet", "rng": "tinymt"},
    "disney_bump_tauslcg": {"material_mode": "disney", "normal_map": 0.8,
                            "rng": "tauslcg"},
    "lights": {"lights": True},
    "lights_microfacet": {"material_mode": "microfacet", "lights": True},
    "lights_disney_bump": {"material_mode": "disney", "normal_map": 0.8,
                           "lights": True},
}


def _material_render(cfg, cam, steps, host_lib=None, lights=None):
    """accum, output and the state planes after `steps` steps of the plain
    step or the host-built header, with `lights` (its Phong albedo written
    into the table, as the render step does)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if lights is not None:
        sc = sc.with_tables(albedo=lights.override_albedo(sc.albedo))
    spheres = sc.packed()
    kl = lights if lights is not None and lights.has_lights else None
    rows = None if kl is None else kl.buffer("cpu").numpy()
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    planes = init_rng_state(cfg)
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            sphere_pt_plain(cfg, sched, cam, spheres, accum, output, planes,
                            kl)
            continue
        ip, fp = step_params(cfg, k, sc.count, cam, kl)
        assert host_lib.l2n_sphere_pt_host(
            _ptr(ip), _ptr(fp), _ptr(sched.numpy()), _ptr(spheres.numpy()),
            None if rows is None else _ptr(rows), _ptr(accum.numpy()),
            _ptr(output.numpy()),
            None if planes is None else _ptr(planes.numpy())) == 0
    return accum.numpy(), output.numpy(), planes


@pytest.mark.parametrize("case", list(MATERIAL_CASES))
def test_material_header_matches_plain_step(lib, case):
    """The kernels' materials body (the material modes, the bump, the
    explicit lights' loop over the staged table rows and light rows) and the
    bumped normal AOV against the plain step on the aimed 16-sphere view,
    2 steps, in every rng mode among the cases: accum[3] equal, accum RMSE
    < 1e-3, output |d| > 1e-3 on under 2e-3 of the values (the C library's
    sinf/cosf against torch's), the stateful modes' state planes
    bit-equal, a lit frame (hits cover a tenth of the view for the AOV)."""
    kw = dict(MATERIAL_CASES[case])
    lights = _explicit_lights() if kw.pop("lights", False) else None
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, **kw).validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    ha, ho, hs = _material_render(cfg, cam, 2, lib, lights)
    pa, po, ps = _material_render(cfg, cam, 2, None, lights)
    lit = (np.abs(pa[:3]).max(0) > 0).mean()
    assert lit > (0.05 if cfg.aov == "normal" else 0.3), lit
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3
    if ps is not None:
        np.testing.assert_array_equal(hs.numpy(), ps.numpy())
    if lights is not None:  # the lights add light to the frame
        base, _, _ = _material_render(cfg, cam, 2)
        assert pa[:3].sum() > 1.05 * base[:3].sum()


@pytest.mark.parametrize("case", ["microfacet", "disney_bump",
                                  "lights_microfacet", "normal_aov_bump"])
def test_material_triangle_header_matches_plain_step(lib, case):
    """The same for meshes: the triangle walk's materials body (the table's
    material rows staged beside the albedo, the lights' shadow casts through
    TriSceneView::nearest) against the plain brute-force step, 2 steps of
    the aimed small triangle config."""
    kw = {"microfacet": {"material_mode": "microfacet"},
          "disney_bump": {"material_mode": "disney", "normal_map": 0.8},
          "lights_microfacet": {"material_mode": "microfacet"},
          "normal_aov_bump": {"normal_map": 0.8, "aov": "normal"}}[case]
    lights = _explicit_lights() if case.startswith("lights") else None
    cfg = TRI_CFG.replace(**kw).validate()
    scene = build_triangle_scene(compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed),
        cfg.disc_lat, cfg.disc_long)
    cam = _tri_aimed_camera(cfg).packed()
    buf = TriangleBuffers.from_scene(scene)
    if lights is not None:
        buf = buf.with_tables(albedo=lights.override_albedo(buf.albedo.T))
    rows = None if lights is None else lights.buffer("cpu").numpy()
    tiles = torch.as_tensor(tile_grid(cfg))
    k = cfg.effective_tiles_per_step
    frames = []
    for host in (True, False):
        accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
        output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
        for i in range(2):
            sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
            if not host:
                triangle_pt_plain(cfg, sched, cam, buf, accum, output,
                                  None, lights)
                continue
            m, s = buf.slab_bounds.shape[:2]
            ip, fp = step_params(cfg, k, m, cam, lights)
            arrays = [sched, *buf.kernel_arrays()]
            assert lib.l2n_triangle_pt_host(
                _ptr(ip), _ptr(fp), s, s * 128,
                *(_ptr(a.numpy()) for a in arrays),
                None if rows is None else _ptr(rows), _ptr(accum.numpy()),
                _ptr(output.numpy()), None) == 0
        frames.append((accum.numpy(), output.numpy()))
    (ha, ho), (pa, po) = frames
    assert (np.abs(pa[:3]).max(0) > 0).mean() > 0.05
    np.testing.assert_array_equal(ha[3], pa[3])
    d = np.abs(ha - pa)
    assert np.sqrt((d ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


@pytest.mark.parametrize("mode", ["microfacet", "disney"])
def test_material_wavefront_header_matches_plain_step(lib, mode):
    """Passes A, B (each ray's sweeps split into 8 parts) and C of the
    headers' materials body, chained on the host, against the plain
    wavefront step, which resumes pass B's stream at (3, False) in the
    material modes (no spare pending): 2 steps of the aimed view with the
    bump and 2 spp, the fused step's gates."""
    from l2n_tpu_torch.ops.kernels.wavefront import (
        sphere_wavefront_step_plain,
    )
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, wavefront=True, spp_per_step=2,
                       material_mode=mode, normal_map=0.8).validate()
    assert wavefront_draw_position(cfg) == (3, False)
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                              cfg.scene_seed).packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    k = cfg.effective_tiles_per_step
    n = k * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    ip, fp = step_params(cfg, k, spheres.shape[1], cam)
    frames = []
    for host in (True, False):
        accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
        output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
        for i in range(2):
            sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
            if not host:
                sphere_wavefront_step_plain(cfg, sched, cam, spheres, accum,
                                            output)
                continue
            col, back = np.empty((3, n), np.float32), np.empty((3, n),
                                                                np.float32)
            rays = np.empty((9, n), np.float32)
            meta = np.empty((3, n), np.int32)
            n_alive = np.zeros(1, np.int32)
            assert lib.l2n_wavefront_pass_a_host(
                _ptr(ip), _ptr(fp), _ptr(sched.numpy()),
                _ptr(spheres.numpy()), _ptr(accum.numpy()),
                *map(_ptr, (col, back, rays, meta, n_alive))) == 0
            assert 0 < n_alive[0] < n
            assert lib.l2n_wavefront_pass_b_host(
                _ptr(ip), _ptr(fp), 8, 3, 0,
                *map(_ptr, (n_alive, spheres.numpy(), rays, meta)), None,
                _ptr(back)) == 0
            assert lib.l2n_wavefront_pass_c_host(
                _ptr(ip), _ptr(fp), _ptr(sched.numpy()), _ptr(col),
                _ptr(back), _ptr(accum.numpy()), _ptr(output.numpy())) == 0
        frames.append((accum.numpy(), output.numpy()))
    (ha, ho), (pa, po) = frames
    assert (pa[:3].max(0) > 0).mean() > 0.3
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


ASAN_MATERIALS = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from l2n_tpu_torch.scene.materials import DirectionalLights, PointLights
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 16
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
# Two point lights and three directional ones, each buffer exactly its
# size: the light loop reads 6 floats per light and no more.
lights = ExplicitLights(None, PointLights.from_arrays(
    np.array([[0, 0, 0], [100, 200, -50]], np.float32),
    np.array([[5e7, 4e7, 3e7], [1e7, 1e7, 1e7]], np.float32)),
    DirectionalLights.from_arrays(
        np.array([[0.3, -1, 0.2], [0, 0, 1], [-1, 0.5, 0]], np.float32),
        np.full((3, 3), 0.5, np.float32)))
rows = np.ascontiguousarray(lights.buffer("cpu").numpy())
for mode in ("microfacet", "disney"):
    cfg = RenderConfig(width=128, height=64, material_mode=mode,
                       normal_map=0.8)
    cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
    sched = np.ascontiguousarray(tile_grid(cfg), np.int32)
    cam = Camera.from_config(cfg).packed()
    # spheres: the (13, n) table of exactly n columns; 13 spheres
    for count in (128, 13):
        spheres = np.ascontiguousarray(compute_spheres(count).packed().numpy())
        accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
        output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
        ip, fp = step_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
    tcfg = cfg.replace(scene_kind="triangle").validate()
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(16),
                                                          8, 8))
    m, s = buf.slab_bounds.shape[:2]
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = step_params(tcfg, tcfg.tile_count, m, cam, lights)
    arrays = [np.ascontiguousarray(t.numpy()) for t in buf.kernel_arrays()]
    assert lib.l2n_triangle_pt_host(
        ptr(ip), ptr(fp), s, s * 128, ptr(sched), *map(ptr, arrays),
        ptr(rows), ptr(accum), ptr(output), None) == 0
    assert accum[3].sum() == cfg.padded_height * cfg.padded_width
print("clean")
"""


def test_material_header_memcheck_asan(asan_build):
    """The memory check of the materials body (ROADMAP Queue 3 #15): the
    header built with AddressSanitizer renders whole frames of the
    microfacet and Disney modes with the bump and five explicit lights, on
    128 and 13 spheres and on 16 tessellated meshes, every table, light
    and scene buffer a heap array of exactly its size: the extra table rows
    and the light loop read nothing past them."""
    _asan_render(asan_build, script=ASAN_MATERIALS)


# ---------------------------------------------------------------------------
# Next event estimation and MIS (csrc/pathtrace.cuh next_event, nee_area,
# nee_cone, mis_emission_weight; the NEE body)
# ---------------------------------------------------------------------------

def _nee_lanes(centres, radii, lights_every, n=2048, seed=81):
    """Vertices just outside the diffuse spheres (centres (3, count),
    radii), normals scaled to lengths 0.5 to 2 and their unit normals, wo in
    their upper hemisphere, albedo, throughput, the draws (u_pick, ul1,
    ul2) and (6, n) material rows (roughness 0.4)."""
    gen = np.random.Generator(np.random.PCG64(seed))
    idx = gen.integers(0, centres.shape[1], n)
    idx[idx % lights_every == 0] += 1
    nu = gen.normal(size=(3, n))
    nu /= np.linalg.norm(nu, axis=0)
    h = centres[:, idx] + nu * radii[idx] * 1.001
    nv = nu * (0.5 + 1.5 * gen.random(n))
    wo = nu * 0.6 + gen.normal(size=(3, n)) * 0.3
    wo /= np.linalg.norm(wo, axis=0)
    mat = gen.random((6, n))
    mat[0] = 0.4
    u = gen.random((3, n)).clip(1e-7, 1 - 1e-7)
    f = np.float32
    return {k: np.ascontiguousarray(v, f) for k, v in dict(
        h=h, nv=nv, nu=nu, wo=wo, kd=gen.random((3, n)),
        tp=gen.random((3, n)), u=u, mat=mat).items()}


def _nee_plain_eval(lanes, mode):
    """The plain BSDF eval of the lanes for NEE (None: Lambert)."""
    if mode == "lambert":
        return None
    from l2n_tpu_torch.maths.brdf import eval_brdf
    t = {k: tuple(torch.from_numpy(v[i]) for i in range(v.shape[0]))
         for k, v in lanes.items()}
    return lambda wi: eval_brdf(t["nu"], t["wo"], wi, t["kd"], t["mat"][0])


def _nee_host_vs_plain(lib_fn, scene_args, plain_fn, cfg, lanes, mode, mis):
    """The header's NEE against the plain function on the lanes: bit-equal
    wherever the C library's sinf/cosf of the azimuth 2 pi ul2 equal
    torch's (over 90% of lanes), finite elsewhere; some lanes lit, some
    not."""
    from l2n_tpu_torch.ops.kernels.common import MATERIAL_CODES
    n = lanes["u"].shape[1]
    col = np.zeros((3, n), np.float32)
    code = 0 if mode == "lambert" else MATERIAL_CODES[mode]
    lib_fn(*scene_args, code, int(mis), *(_ptr(lanes[k]) for k in (
        "u", "h", "nv", "nu", "wo", "kd", "mat", "tp")), n, _ptr(col))
    t = {k: tuple(torch.from_numpy(v[i]) for i in range(v.shape[0]))
         for k, v in lanes.items()}
    want = np.stack([x.numpy() for x in plain_fn(
        t, _nee_plain_eval(lanes, mode))])
    phi = (torch.from_numpy(lanes["u"][2]) * (2.0 * np.pi)).numpy()
    agree = _libm_trig_agrees(phi)
    assert agree.mean() > 0.9
    np.testing.assert_array_equal(col[:, agree], want[:, agree])
    assert np.isfinite(col).all()
    lit = (want.max(0) > 0).mean()
    assert 0.05 < lit < 0.95, lit


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("mode", ["lambert", "microfacet"])
def test_nee_area_header_matches_plain(lib, mode, mis):
    """nee_area (a point on a light sphere, one shadow ray over every
    sphere) at vertices on the default 128 spheres against ops/nee.py's
    nee_contribution with the same draws."""
    from l2n_tpu_torch.ops import nee
    from l2n_tpu_torch.ops.scenes import sphere_intersector
    cfg = RenderConfig(nee=True, mis=mis).validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    lanes = _nee_lanes(spheres[:3].numpy(), np.sqrt(spheres[3].numpy()), 16)
    ip, fp = step_params(cfg, 1, sc.count, Camera.from_config(cfg).packed())
    sampler = nee.sphere_light_sampler(cfg, spheres)
    intersect = sphere_intersector(*spheres[:4])

    def plain(t, brdf_eval):
        light = sampler.sample(*t["u"])
        return nee.nee_contribution(cfg, sampler.n_lights, intersect, light,
                                    t["h"], t["nv"], t["kd"], t["tp"], mis,
                                    brdf_eval)

    _nee_host_vs_plain(lib.l2n_nee_area_host,
                       (_ptr(ip), _ptr(fp), _ptr(spheres.numpy())), plain,
                       cfg, lanes, mode, mis)


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("mode", ["lambert", "microfacet"])
def test_nee_cone_header_matches_plain(lib, mode, mis):
    """nee_cone (a direction in the cone of a light mesh's bound, traced
    through the bound walk) at vertices just outside the meshes of 16
    tessellated spheres (lights every 4th) against ops/nee.py's
    nee_cone_contribution over the brute-force soup sweep."""
    from l2n_tpu_torch.ops import nee
    from l2n_tpu_torch.ops.scenes import triangle_intersector
    cfg = RenderConfig(sphere_count=16, emissive_every=4, nee=True, mis=mis,
                       scene_kind="triangle").validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    buf = TriangleBuffers.from_scene(build_triangle_scene(sc, 8, 6))
    centres = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                        sc.center_z.numpy()])
    lanes = _nee_lanes(centres, np.sqrt(sc.sqr_radius.numpy()), 4)
    m, s = buf.slab_bounds.shape[:2]
    ip, fp = step_params(cfg, 1, m, Camera.from_config(cfg).packed())
    sampler = nee.mesh_light_sampler(cfg, buf.mesh_bounds)
    intersect = triangle_intersector(buf.soup, buf.mesh_bounds[:, 3])

    def plain(t, brdf_eval):
        return nee.nee_cone_contribution(cfg, sampler, intersect, *t["u"],
                                         t["h"], t["nv"], t["kd"], t["tp"],
                                         mis, brdf_eval)

    _nee_host_vs_plain(lib.l2n_nee_cone_host, (
        _ptr(ip), _ptr(fp), s, s * 128, *_scene_ptrs(buf)),
        plain, cfg, lanes, mode, mis)


@pytest.mark.parametrize("kind", ["area", "cone"])
def test_mis_weight_header_matches_plain(lib, kind):
    """mis_emission_weight per lane against ops/nee.py's, bit-equal (no
    transcendental): the area form from the hit's normal, distance and r^2;
    the cone form from the hit mesh's bound (the (M, 4) bounds indexed by
    the hit)."""
    from l2n_tpu_torch.ops import nee
    gen = np.random.Generator(np.random.PCG64(83))
    n, count = 4096, 24
    f = np.float32
    prev_pdf = (gen.random(n) * 0.5).astype(f)
    d = gen.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(f)
    t = (gen.random(n) * 40).astype(f)
    nrm = (gen.normal(size=(3, n)) * 0.9).astype(f)
    r2 = (gen.random(n) * 9).astype(f)
    index = gen.integers(0, count, n).astype(np.int32)
    cfg = RenderConfig(sphere_count=count, emissive_every=8, nee=True,
                       mis=True,
                       scene_kind="sphere" if kind == "area" else "triangle")
    if kind == "area":
        scene = compute_spheres(count).packed().numpy()
    else:
        scene = np.ascontiguousarray(np.concatenate(
            [gen.normal(size=(count, 3)) * 50, gen.random((count, 1)) * 30],
            1), f)
    ip, fp = step_params(cfg, 1, count, Camera.from_config(cfg).packed())
    out = np.zeros(n, f)
    lib.l2n_mis_weight_host(_ptr(ip), _ptr(fp), int(kind == "cone"),
                            *map(_ptr, (scene, prev_pdf, d, t, nrm, r2,
                                        index)), n, _ptr(out))
    rows = torch.from_numpy(scene[:4] if kind == "area" else scene.T)
    sampler = nee.LightSampler(kind, rows, cfg.emissive_every)
    tt = torch.from_numpy
    want = nee.mis_emission_weight(
        cfg, sampler, tt(prev_pdf), tuple(map(tt, d)), tt(t),
        tuple(map(tt, nrm)), tt(r2), rows[3][tt(index).long()])
    np.testing.assert_array_equal(out, want.numpy())
    assert 0.01 < (out < 0.5).mean() < 0.99


NEE_CASES = {
    "nee": {"nee": True},
    "nee_tpu_hw": {"nee": True, "rng": "tpu_hw"},
    "mis": {"nee": True, "mis": True},
    "mis_tpu_hw": {"nee": True, "mis": True, "rng": "tpu_hw"},
    "mis_microfacet_bump": {"nee": True, "mis": True,
                            "material_mode": "microfacet", "normal_map": 0.8},
    "mis_lights": {"nee": True, "mis": True, "lights": True},
    "mis_fast_viewproj": {"nee": True, "mis": True, "fast_math": True,
                          "ray_gen": "viewproj"},
}


@pytest.mark.parametrize("case", list(NEE_CASES))
def test_nee_header_matches_plain_step(lib, case):
    """The kernels' NEE body (the materials body with next_event and the
    MIS weight at emissive hits, fast_math and the camera form read at run
    time) against the plain step on the aimed 16-sphere view (8 lights), 2
    steps, in threefry and tpu_hw, with and without MIS, with the
    microfacet mode and the bump, and with the explicit lights: the gates
    of test_material_header_matches_plain_step, and NEE changes the pixels
    of the diffuse surfaces in view (the same expectation, another
    estimator: 3% of this view)."""
    kw = dict(NEE_CASES[case])
    lights = _explicit_lights() if kw.pop("lights", False) else None
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, **kw).validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    ha, ho, _ = _material_render(cfg, cam, 2, lib, lights)
    pa, po, _ = _material_render(cfg, cam, 2, None, lights)
    assert (np.abs(pa[:3]).max(0) > 0).mean() > 0.3
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3
    base, _, _ = _material_render(cfg.replace(nee=False, mis=False), cam, 2,
                                  None, lights)
    assert (np.abs(pa[:3] - base[:3]).max(0) > 0).mean() > 0.01


@pytest.mark.parametrize("case", ["nee", "nee_tpu_hw", "mis", "mis_tpu_hw"])
def test_nee_triangle_header_matches_plain_step(lib, case):
    """The same for meshes: cone NEE through the bound walk, the MIS weight
    from the staged mesh bounds, against the plain brute-force step, 2
    steps of the small triangle config with every other mesh a light, the
    camera up close at the diffuse mesh 1 from the side of the light mesh
    0 (its BSDF rays find the light: the MIS weight matters)."""
    kw = NEE_CASES[case]
    cfg = TRI_CFG.replace(emissive_every=2, **kw).validate()
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    scene = build_triangle_scene(sp, cfg.disc_lat, cfg.disc_long)
    c = np.stack([sp.center_x.numpy(), sp.center_y.numpy(),
                  sp.center_z.numpy()], 1).astype(np.float64)
    r1 = float(np.sqrt(float(sp.sqr_radius[1])))
    to = (c[0] - c[1]) / np.linalg.norm(c[0] - c[1])
    vm = look_at((c[1] + to * 2.5 * r1).astype(np.float32),
                 c[1].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    ha, ho = _render_triangles(cfg, scene, cam, 2, lib)
    pa, po = _render_triangles(cfg, scene, cam, 2)
    assert (np.abs(pa[:3]).max(0) > 0).mean() > 0.05
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


@pytest.mark.parametrize("kw", [
    pytest.param({"nee": True}, id="nee"),
    pytest.param({"nee": True, "mis": True}, id="mis"),
    pytest.param({"nee": True, "mis": True, "material_mode": "microfacet",
                  "normal_map": 0.8}, id="mis_microfacet_bump")])
def test_nee_wavefront_header_matches_plain_step(lib, kw):
    """Passes A, B (each ray's sweeps split into 8 parts) and C of the
    headers' NEE body, chained on the host with 10 ray planes under MIS
    and pass B resumed where the replay says (Lambert (4, False), the
    material modes (5, True): a spare pending across the split), against
    the plain wavefront step: 2 steps of the aimed view at 2 spp, the fused
    step's gates."""
    from l2n_tpu_torch.ops.kernels.wavefront import (
        ray_planes,
        sphere_wavefront_step_plain,
    )
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, wavefront=True, spp_per_step=2,
                       **kw).validate()
    next_pair, has_spare = wavefront_draw_position(cfg)
    assert (next_pair, has_spare) == ((5, True) if "material_mode" in kw
                                      else (4, False))
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                              cfg.scene_seed).packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    k = cfg.effective_tiles_per_step
    n = k * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    ip, fp = step_params(cfg, k, spheres.shape[1], cam)
    frames = []
    for host in (True, False):
        accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
        output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
        for i in range(2):
            sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
            if not host:
                sphere_wavefront_step_plain(cfg, sched, cam, spheres, accum,
                                            output)
                continue
            col, back = (np.empty((3, n), np.float32) for _ in range(2))
            rays = np.empty((ray_planes(cfg), n), np.float32)
            meta = np.empty((3, n), np.int32)
            n_alive = np.zeros(1, np.int32)
            assert lib.l2n_wavefront_pass_a_host(
                _ptr(ip), _ptr(fp), _ptr(sched.numpy()),
                _ptr(spheres.numpy()), _ptr(accum.numpy()),
                *map(_ptr, (col, back, rays, meta, n_alive))) == 0
            assert 0 < n_alive[0] < n
            assert lib.l2n_wavefront_pass_b_host(
                _ptr(ip), _ptr(fp), 8, next_pair, int(has_spare),
                *map(_ptr, (n_alive, spheres.numpy(), rays, meta, col,
                            back))) == 0
            assert lib.l2n_wavefront_pass_c_host(
                _ptr(ip), _ptr(fp), _ptr(sched.numpy()), _ptr(col),
                _ptr(back), _ptr(accum.numpy()), _ptr(output.numpy())) == 0
        frames.append((accum.numpy(), output.numpy()))
    (ha, ho), (pa, po) = frames
    assert (pa[:3].max(0) > 0).mean() > 0.3
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


ASAN_NEE = r"""
import ctypes, sys
import numpy as np
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.kernels.wavefront import ray_planes
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.ops.pathtrace import wavefront_draw_position
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from l2n_tpu_torch.scene.materials import PointLights
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 16
lib.l2n_wavefront_pass_a_host.argtypes = [p] * 10
lib.l2n_wavefront_pass_b_host.argtypes = [p, p, i, i, i] + [p] * 6
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
lights = ExplicitLights(None, PointLights.from_arrays(
    np.zeros((1, 3), np.float32), np.full((1, 3), 5e7, np.float32)))
rows = np.ascontiguousarray(lights.buffer("cpu").numpy())
for mode in ("procedural", "microfacet"):
    cfg = RenderConfig(width=128, height=64, spp_per_step=2, nee=True,
                       mis=True, material_mode=mode)
    cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
    sched = np.ascontiguousarray(tile_grid(cfg), np.int32)
    cam = Camera.from_config(cfg).packed()
    # the sphere table of exactly n columns; 13 spheres: the last light
    # row e * 16 = 0 is the only one, 200: a light at column 192
    for count in (128, 13, 200):
        spheres = np.ascontiguousarray(compute_spheres(count).packed().numpy())
        accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
        output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
        ip, fp = step_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
        # the wavefront passes: ray planes of exactly 10 x n_lanes
        wcfg = cfg.replace(wavefront=True)
        ip, fp = step_params(wcfg, cfg.tile_count, count, cam)
        n = cfg.tile_count * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
        col = np.empty((3, n), np.float32)
        back = np.full((3, n), np.nan, np.float32)
        rays = np.empty((ray_planes(wcfg), n), np.float32)
        meta = np.empty((3, n), np.int32)
        n_alive = np.full(1, -1, np.int32)
        assert rays.shape[0] == 10
        accum[:] = 0
        assert lib.l2n_wavefront_pass_a_host(*map(ptr, (
            ip, fp, sched, spheres, accum, col, back, rays, meta,
            n_alive))) == 0
        assert 0 < n_alive[0] < n
        next_pair, has_spare = wavefront_draw_position(wcfg)
        for group in (1, 8):
            b, c = back.copy(), col.copy()
            assert lib.l2n_wavefront_pass_b_host(
                ptr(ip), ptr(fp), group, next_pair, int(has_spare),
                *map(ptr, (n_alive, spheres, rays, meta, c, b))) == 0
            assert not np.isnan(b).any()
            # pass B took over each survivor's col: 0 there, kept elsewhere
            alive = np.zeros(n, bool)
            alive[meta[2, :n_alive[0]]] = True
            assert (c[:, alive] == 0).all()
            assert np.array_equal(c[:, ~alive], col[:, ~alive])
    tcfg = cfg.replace(scene_kind="triangle").validate()
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(40),
                                                          8, 8))
    m, s = buf.slab_bounds.shape[:2]
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = step_params(tcfg, tcfg.tile_count, m, cam, lights)
    arrays = [np.ascontiguousarray(t.numpy()) for t in buf.kernel_arrays()]
    assert lib.l2n_triangle_pt_host(
        ptr(ip), ptr(fp), s, s * 128, ptr(sched), *map(ptr, arrays),
        ptr(rows), ptr(accum), ptr(output), None) == 0
    assert accum[3].sum() == 2 * cfg.padded_height * cfg.padded_width
print("clean")
"""


def test_nee_header_memcheck_asan(asan_build):
    """The memory check of the NEE body (ROADMAP Queue 3 #15): the headers
    built with AddressSanitizer render whole frames of NEE with MIS and a
    point light, procedural and microfacet, on 128, 13 and 200 spheres (the
    light rows e * 16 read from a table of exactly n columns) and on 40
    tessellated meshes (the light bounds from mesh bounds of exactly M
    rows), and run wavefront passes A and B into ray planes of exactly 10
    x n_lanes floats: pass A writes and pass B reads the 10th plane within
    them, and pass B takes over each survivor's col (0 after it)."""
    _asan_render(asan_build, script=ASAN_NEE)


# ---------------------------------------------------------------------------
# Homogeneous fog: the fog body (csrc/pathtrace.cuh trace_fog) and fog's
# Beer-Lambert factors on NEE and the explicit lights
# ---------------------------------------------------------------------------

# The aimed view looks mostly at the sky: a sky shell at 250 (its miss
# flights reach it with probability 0.61) keeps it lit.
FOG = {"fog_density": 0.002, "fog_albedo": 0.8, "fog_sky_distance": 250.0}
FOG_CASES = {
    "fog": {},
    "fog_one_bounce": {"max_bounces": 1},
    "fog_three_bounces_sun": {"max_bounces": 3, "env_mode": "sun"},
    "fog_nee": {"nee": True},
    "fog_mis": {"nee": True, "mis": True},
    "fog_mis_tpu_hw": {"nee": True, "mis": True, "rng": "tpu_hw"},
    "fog_mis_microfacet_bump": {"nee": True, "mis": True,
                                "material_mode": "microfacet",
                                "normal_map": 0.8},
    "fog_mis_lights_disney": {"nee": True, "mis": True, "lights": True,
                              "material_mode": "disney"},
    "fog_fast_viewproj": {"fast_math": True, "ray_gen": "viewproj"},
    # sample 1 onward draws at other counters than without fog
    "fog_ao": {"aov": "ambient_occlusion", "spp_per_step": 2},
}


@pytest.mark.parametrize("case", list(FOG_CASES))
def test_fog_header_matches_plain_step(lib, case):
    """The kernels' fog body (each segment's collision draw, the fog
    vertex's isotropic scatter and its draws, the emission rule after a
    fog vertex, the last segment cut by a collision; NEE, MIS, the
    material modes, the bump, the explicit lights, fast_math and the camera
    form read at run time) against the plain step on the aimed 16-sphere
    view, 2 steps, the gates of test_nee_header_matches_plain_step (libm's
    log, exp, sin and cos are not torch's to the ulp), and a tenth of the
    samples or more collide (counted on the plain path); an AOV with fog
    keeps the AOV body and only its draw budget changes, which changes its
    image."""
    kw = dict(FOG_CASES[case])
    lights = _explicit_lights() if kw.pop("lights", False) else None
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, **FOG, **kw).validate()
    cam = Camera.from_config(cfg, _aimed_view(cfg)).packed()
    ha, ho, _ = _material_render(cfg, cam, 2, lib, lights)
    with count_fog_collisions() as counts:
        pa, po, _ = _material_render(cfg, cam, 2, None, lights)
    # the AO hits cover a tenth of the view
    lit = 0.3 if cfg.aov == "pathtracing" else 0.05
    assert (np.abs(pa[:3]).max(0) > 0).mean() > lit
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3
    if cfg.aov == "pathtracing":
        assert counts["collided"] > 0.1 * counts["samples"] > 0
    else:  # sample 1 draws at other counters than without fog
        clear, _, _ = _material_render(cfg.replace(fog_density=0.0), cam, 2)
        assert (np.abs(pa[:3] - clear[:3]).max(0) > 0).mean() > 0.01


def _ulps(got, want) -> np.ndarray:
    """Float32 distance in ulps of same-signed values."""
    g = np.ascontiguousarray(got, np.float32).view(np.int32).astype(np.int64)
    w = np.ascontiguousarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(g - w)


def test_fog_explicit_lights_header_matches_plain(lib):
    """The light loop with fog's factors (kFog: exp(-sigma dist) on the
    point light, the host's float32(exp(-sigma sky)) on the directional
    one) against ops/lights.explicit_light_contribution with fog on the
    lanes of test_explicit_lights_header_matches_plain: libm's expf and
    torch's CPU exp differ by an ulp on some arguments, so bit-equal on
    most lanes and within 2 ulps on all."""
    from l2n_tpu_torch.ops.lights import explicit_light_contribution
    from l2n_tpu_torch.ops.scenes import sphere_intersector
    cfg = RenderConfig(sphere_count=128, fog_density=0.002).validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    gen = np.random.Generator(np.random.PCG64(24))
    n = 4096
    idx = gen.integers(0, 128, n)
    nv = gen.normal(size=(3, n))
    nv /= np.linalg.norm(nv, axis=0)
    c = spheres[:3].numpy()[:, idx].astype(np.float64)
    h = (c + nv * np.sqrt(spheres[3].numpy()[idx])).astype(np.float32)
    nv = nv.astype(np.float32)
    kd = gen.random((3, n), dtype=np.float32)
    tp = gen.random((3, n), dtype=np.float32)
    lights = _explicit_lights()
    ip, fp = step_params(cfg, 1, sc.count, np.zeros((10, 4), np.float32),
                         lights)
    col = np.zeros((3, n), np.float32)
    lib.l2n_explicit_lights_host(_ptr(ip), _ptr(fp), _ptr(spheres.numpy()),
                                 _ptr(lights.buffer("cpu").numpy()),
                                 *map(_ptr, (h, nv, kd, tp)), n, _ptr(col))
    want = torch.stack(explicit_light_contribution(
        cfg, lights, sphere_intersector(*spheres[:4]),
        tuple(torch.from_numpy(h)), tuple(torch.from_numpy(nv)),
        tuple(torch.from_numpy(kd)), tuple(torch.from_numpy(tp)))).numpy()
    assert (col == want).mean() > 0.9
    assert _ulps(col, want).max() <= 2
    clear = torch.stack(explicit_light_contribution(
        cfg.replace(fog_density=0.0), lights,
        sphere_intersector(*spheres[:4]), tuple(torch.from_numpy(h)),
        tuple(torch.from_numpy(nv)), tuple(torch.from_numpy(kd)),
        tuple(torch.from_numpy(tp)))).numpy()
    lit = col.max(0) > 0
    assert 0.1 < lit.mean() < 0.9
    assert (col[:, lit] < clear[:, lit]).all()


@pytest.mark.parametrize("kind", ["area", "cone"])
def test_fog_nee_header_matches_plain(lib, kind):
    """nee_area / nee_cone with fog's Beer-Lambert factor (kFog) against
    ops/nee.py under fog_density 0.002 with MIS, Lambert: on the lanes where
    libm's sinf/cosf of the azimuth equal torch's, within 2 ulps (expf
    against torch's exp) and bit-equal on most of them."""
    from l2n_tpu_torch.ops import nee
    from l2n_tpu_torch.ops.scenes import sphere_intersector, triangle_intersector
    sc = compute_spheres(16 if kind == "cone" else 128)
    if kind == "area":
        cfg = RenderConfig(nee=True, mis=True, fog_density=0.002).validate()
        spheres = sc.packed()
        lanes = _nee_lanes(spheres[:3].numpy(), np.sqrt(spheres[3].numpy()),
                           16)
        ip, fp = step_params(cfg, 1, sc.count, Camera.from_config(cfg).packed())
        sampler = nee.sphere_light_sampler(cfg, spheres)
        intersect = sphere_intersector(*spheres[:4])
        fn, args = lib.l2n_nee_area_host, (_ptr(ip), _ptr(fp),
                                           _ptr(spheres.numpy()))

        def plain(t):
            return nee.nee_contribution(
                cfg, sampler.n_lights, intersect, sampler.sample(*t["u"]),
                t["h"], t["nv"], t["kd"], t["tp"], True)
    else:
        cfg = RenderConfig(sphere_count=16, emissive_every=4, nee=True,
                           mis=True, scene_kind="triangle",
                           fog_density=0.002).validate()
        buf = TriangleBuffers.from_scene(build_triangle_scene(sc, 8, 6))
        centres = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                            sc.center_z.numpy()])
        lanes = _nee_lanes(centres, np.sqrt(sc.sqr_radius.numpy()), 4)
        m, s = buf.slab_bounds.shape[:2]
        ip, fp = step_params(cfg, 1, m, Camera.from_config(cfg).packed())
        sampler = nee.mesh_light_sampler(cfg, buf.mesh_bounds)
        intersect = triangle_intersector(buf.soup, buf.mesh_bounds[:, 3])
        fn = lib.l2n_nee_cone_host
        args = (_ptr(ip), _ptr(fp), s, s * 128, *_scene_ptrs(buf))

        def plain(t):
            return nee.nee_cone_contribution(
                cfg, sampler, intersect, *t["u"], t["h"], t["nv"], t["kd"],
                t["tp"], True)
    n = lanes["u"].shape[1]
    col = np.zeros((3, n), np.float32)
    fn(*args, 0, 1, *(_ptr(lanes[k]) for k in (
        "u", "h", "nv", "nu", "wo", "kd", "mat", "tp")), n, _ptr(col))
    t = {k: tuple(torch.from_numpy(v[i]) for i in range(v.shape[0]))
         for k, v in lanes.items()}
    want = torch.stack(plain(t)).numpy()
    agree = _libm_trig_agrees(lanes["u"][2] * np.float32(2.0 * np.pi))
    assert agree.mean() > 0.9
    assert (col[:, agree] == want[:, agree]).mean() > 0.9
    assert _ulps(col[:, agree], want[:, agree]).max() <= 2
    lit = (want.max(0) > 0).mean()
    assert 0.05 < lit < 0.95, lit


@pytest.mark.parametrize("case", ["fog_mis", "fog_tpu_hw"])
def test_fog_triangle_header_matches_plain_step(lib, case):
    """The fog body over meshes (cone NEE through the bound walk with fog's
    factor, the fog vertices' scatter, the any-hit walk of the last
    segment) against the plain brute-force step: 2 steps of the small
    triangle config from beside the light mesh 0 at the diffuse mesh 1,
    the gates of test_nee_triangle_header_matches_plain_step."""
    kw = {"fog_mis": {"nee": True, "mis": True},
          "fog_tpu_hw": {"nee": True, "rng": "tpu_hw"}}[case]
    cfg = TRI_CFG.replace(emissive_every=2, **FOG, **kw).validate()
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    scene = build_triangle_scene(sp, cfg.disc_lat, cfg.disc_long)
    c = np.stack([sp.center_x.numpy(), sp.center_y.numpy(),
                  sp.center_z.numpy()], 1).astype(np.float64)
    r1 = float(np.sqrt(float(sp.sqr_radius[1])))
    to = (c[0] - c[1]) / np.linalg.norm(c[0] - c[1])
    vm = look_at((c[1] + to * 2.5 * r1).astype(np.float32),
                 c[1].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    ha, ho = _render_triangles(cfg, scene, cam, 2, lib)
    with count_fog_collisions() as counts:
        pa, po = _render_triangles(cfg, scene, cam, 2)
    assert (np.abs(pa[:3]).max(0) > 0).mean() > 0.05
    assert counts["collided"] > 0.05 * counts["samples"] > 0
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


ASAN_FOG = r"""
import ctypes, sys
import numpy as np
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from l2n_tpu_torch.scene.materials import DirectionalLights, PointLights
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 16
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
lights = ExplicitLights(None, PointLights.from_arrays(
    np.zeros((1, 3), np.float32), np.full((1, 3), 5e7, np.float32)),
    DirectionalLights.from_arrays(np.array([[0.3, -1.0, 0.2]], np.float32),
                                  np.full((1, 3), 0.5, np.float32)))
rows = np.ascontiguousarray(lights.buffer("cpu").numpy())
for kw in ({"max_bounces": 1}, {"nee": True, "mis": True,
                                "material_mode": "microfacet"}):
    cfg = RenderConfig(width=128, height=64, fog_density=0.002, **kw)
    cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
    sched = np.ascontiguousarray(tile_grid(cfg), np.int32)
    cam = Camera.from_config(cfg).packed()
    for count in (13, 200):
        spheres = np.ascontiguousarray(compute_spheres(count).packed().numpy())
        accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
        output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
        ip, fp = step_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
    tcfg = cfg.replace(scene_kind="triangle").validate()
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(40),
                                                          4, 4))
    m, s = buf.slab_bounds.shape[:2]
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = step_params(tcfg, tcfg.tile_count, m, cam, lights)
    arrays = [np.ascontiguousarray(t.numpy()) for t in buf.kernel_arrays()]
    assert lib.l2n_triangle_pt_host(
        ptr(ip), ptr(fp), s, s * 128, ptr(sched), *map(ptr, arrays),
        ptr(rows), ptr(accum), ptr(output), None) == 0
    assert accum[3].sum() == cfg.padded_height * cfg.padded_width
print("clean")
"""


def test_fog_header_memcheck_asan(asan_build):
    """The memory check of the fog body (ROADMAP Queue 3 #15), with the
    NEE body's ASan build: whole frames of fog at one bounce (the last
    segment's collision draw after the any-hit) and of fog with NEE, MIS
    and microfacet, a point and a directional light, on 13 and 200 spheres
    (light rows e * 16 of a table of exactly n columns) and 40 tessellated
    meshes."""
    _asan_render(asan_build, script=ASAN_FOG)


def test_triangle_walk_keeps_far_grazing_hits(lib):
    """The walk's bound tests never reject a bound the brute-force sweep
    finds a hit in: rays from 500 to 1500 units away through the outer
    shell (0.9 to 1 of the radius) of the default scene's small mesh
    bounds, the two NEE shadow rays a card run caught the sqrt-free test
    rejecting (toward mesh 56, radius 0.82, 924 and 948 away) among them:
    the nearest hit (t, mesh) and the any-hit bit-equal to the plain
    sweep's on every ray, most of them hits."""
    from l2n_tpu_torch.ops.scenes import triangle_intersector
    cfg = RenderConfig(scene_kind="triangle").validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    buf = TriangleBuffers.from_scene(build_triangle_scene(
        sc, cfg.disc_lat, cfg.disc_long))
    mb = buf.mesh_bounds.numpy().astype(np.float64)
    gen = np.random.Generator(np.random.PCG64(56))
    n = 1024
    m = gen.integers(0, mb.shape[0], n)
    dirs = gen.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    side = gen.normal(size=(n, 3))
    side -= (side * dirs).sum(1, keepdims=True) * dirs
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    reach = np.sqrt(mb[m, 3]) * (0.9 + 0.1 * gen.random(n))
    dist = 500.0 + 1000.0 * gen.random(n)
    o = mb[m, :3] + side * reach[:, None] - dirs * dist[:, None]
    rays = np.concatenate([o, dirs], 1).astype(np.float32)
    caught = np.array([
        [-246.5607147216797, -253.21359252929688, 203.11009216308594,
         0.7402217388153076, 0.5173520445823669, -0.4294397532939911],
        [-481.64813232421875, 197.2623748779297, 35.92717361450195,
         0.9698176383972168, 0.02880021743476391, -0.2421243041753769]],
        np.float32)
    rays = np.ascontiguousarray(np.concatenate([caught, rays]).T)
    t, index = _cast(lib, 0, buf, rays)
    _, hit = _cast(lib, 1, buf, rays)
    want = triangle_intersector(buf.soup)(*(torch.from_numpy(r)
                                            for r in rays))
    np.testing.assert_array_equal(t, want.t.numpy())
    np.testing.assert_array_equal(index, want.index.numpy())
    np.testing.assert_array_equal(hit.astype(bool), want.t.numpy() >= 0.0)
    assert index[0] == index[1] == 56
    assert (index >= 0).mean() > 0.5


# --- the slab-group level and certain-hit seeding (ROADMAP Queue 2 #3, #4) --

@functools.lru_cache(maxsize=None)
def _seeded_buffers(name):
    """The walk's three cases: the default scene reduced to 16 spheres (2
    slabs per mesh, every mesh an inscribed sphere), two tori (3 slabs per
    mesh, interior balls, no inscribed sphere) and a small trefoil knot
    (one mesh of 15 slabs in 2 groups, the second partial; balls and a
    tiny inscribed sphere)."""
    if name == "default16":
        scene = build_triangle_scene(compute_spheres(16))
    elif name == "tori2":
        scene = load_obj(torus_field_obj(n_tori=2, seg_u=16, seg_v=10))
    else:
        scene = load_obj(trefoil_obj(seg_u=48, seg_v=20))
    return TriangleBuffers.from_scene(scene)


def _surface_rays(buf, n=1536, seed=17):
    """Rays (6, n) float32 of three kinds, a third each: from 2-6 bound
    radii outside, aimed at a random surface point; bounce rays from a
    random surface point in a random direction (half of them into the
    solid); and the same from 1e-3 along their direction."""
    soup = {k: v.numpy() for k, v in buf.soup.items()}
    gen = np.random.Generator(np.random.PCG64(seed))
    ti = gen.integers(0, soup["v1x"].shape[0], n)
    u = gen.random(n)
    v = gen.random(n) * (1.0 - u)
    p = np.stack([soup[f"v1{a}"][ti] + u * soup[f"e1{a}"][ti]
                  + v * soup[f"e2{a}"][ti] for a in "xyz"], 1)
    d = gen.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mb = buf.mesh_bounds.numpy().astype(np.float64)
    mesh = soup["mesh_id"][ti]
    k = n // 3
    reach = np.sqrt(mb[mesh[:k], 3]) * (2.0 + 4.0 * gen.random(k))
    o = p.copy()
    o[:k] = p[:k] - d[:k] * reach[:, None]
    o[2 * k:] = p[2 * k:] + 1e-3 * d[2 * k:]
    return np.ascontiguousarray(
        np.concatenate([o, d], 1).astype(np.float32).T)


SEEDED_SCENES = ["default16", "tori2", "trefoil"]


@pytest.mark.parametrize("cast", ["nearest", "anyhit", "occluded"])
@pytest.mark.parametrize("name", SEEDED_SCENES)
def test_seeded_walk_header_matches_brute_force(lib, name, cast):
    """nearest, anyhit and occluded over the three scenes' packed data
    (inscribed spheres, interior balls, slab groups) against the plain
    brute-force sweep, bit-equal, with bounce origins on the surface;
    `occluded` along directions of length 0.5-1. For nearest and anyhit,
    the seeds that the header's walks took (L2N_NOTE_SEED) equal
    certain_hit_seed's bit for bit and many casts are seeded; for nearest,
    the casts that walk again are exactly those takes_fallback counts."""
    from l2n_tpu_torch.ops.scenes import triangle_intersector
    buf = _seeded_buffers(name)
    rays = _surface_rays(buf)
    if cast == "occluded":
        scale = np.random.Generator(np.random.PCG64(3)).uniform(
            0.5, 1.0, rays.shape[1]).astype(np.float32)
        rays[3:] = rays[3:] * scale
    want = triangle_intersector(buf.soup)(*(torch.from_numpy(r)
                                            for r in rays))
    lib.l2n_fallbacks_host()
    t, index, header_seed = _cast(
        lib, ["nearest", "anyhit", "occluded"].index(cast), buf, rays,
        seeds=True)
    fallbacks = lib.l2n_fallbacks_host()
    seed = certain_hit_seed(buf, *(torch.from_numpy(r) for r in rays))
    if cast != "occluded":
        np.testing.assert_array_equal(header_seed, seed.numpy())
        assert (seed < float("inf")).float().mean() > 0.05
    if cast != "nearest":
        np.testing.assert_array_equal(index.astype(bool),
                                      want.t.numpy() >= 0.0)
        assert 0.3 < (index != 0).mean() < 1.0
        return
    np.testing.assert_array_equal(t, want.t.numpy())
    np.testing.assert_array_equal(index, want.index.numpy())
    assert fallbacks == int(takes_fallback(seed, want.t).sum())


@pytest.mark.parametrize("name", SEEDED_SCENES)
def test_seeded_walk_header_fallback(lib, name):
    """A seed below the true hit: every mesh's inscribed sphere forged to
    its bound (inner_gap 0), so a cast that enters a bound is seeded at
    the bound's entry or exit. Most hitting casts find nothing under the
    seed and walk again; nearest and anyhit still return the brute-force
    sweep's hits, bit for bit, and the fallbacks are those takes_fallback
    counts."""
    from l2n_tpu_torch.ops.scenes import triangle_intersector
    buf = _seeded_buffers(name)
    forged = dataclasses.replace(buf,
                                 inner_gap=torch.zeros_like(buf.inner_gap))
    rays = _surface_rays(forged, seed=23)
    want = triangle_intersector(buf.soup)(*(torch.from_numpy(r)
                                            for r in rays))
    lib.l2n_fallbacks_host()
    t, index = _cast(lib, 0, forged, rays)
    fallbacks = lib.l2n_fallbacks_host()
    np.testing.assert_array_equal(t, want.t.numpy())
    np.testing.assert_array_equal(index, want.index.numpy())
    seed = certain_hit_seed(forged, *(torch.from_numpy(r) for r in rays))
    assert fallbacks == int(takes_fallback(seed, want.t).sum())
    assert fallbacks > 0.25 * int((want.t >= 0).sum())
    _, hit = _cast(lib, 1, forged, rays)
    assert lib.l2n_fallbacks_host() > 0
    np.testing.assert_array_equal(hit.astype(bool), want.t.numpy() >= 0.0)


def _trefoil_view(cfg, scene, offset=(0.35, 0.25, 1.0), dist=1.6):
    """tests/test_bigmesh.py::aimed_camera: the knot fills the view."""
    verts = np.asarray(scene.vertices).reshape(-1, 3)
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    vm = look_at(target + np.asarray(offset, np.float32) * dist * radius,
                 target, np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed()


@pytest.mark.parametrize("aov", ["pathtracing", "ambient_occlusion"])
def test_triangle_header_trefoil_groups(lib, aov):
    """Whole steps over the small trefoil (15 slabs: the group level, its
    partial second group, the balls' seeds) from test_bigmesh's view:
    the header's render equals the plain brute-force step's, 2 steps."""
    cfg = RenderConfig(width=128, height=64, tiles_per_step=2, aov=aov,
                       scene_kind="triangle").validate()
    scene = load_obj(trefoil_obj(seg_u=48, seg_v=20))
    cam = _trefoil_view(cfg, scene)
    ha, _ = _render_triangles(cfg, scene, cam, 2, host_lib=lib)
    pa, _ = _render_triangles(cfg, scene, cam, 2)
    assert (pa[:3].max(0) > 0).mean() > 0.1
    np.testing.assert_array_equal(ha, pa)


# The knot behind a light (probes/step_ab.py lit_knot) per triangle_pt
# body: materials (under the sun sky), NEE, fog, and the AO AOV.
LIT_KNOT_SETTINGS = {
    "microfacet_bump_sun": {"material_mode": "microfacet", "normal_map": 0.8,
                            "env_mode": "sun"},
    "nee_mis_microfacet": {"nee": True, "mis": True,
                           "material_mode": "microfacet"},
    "fog_nee_mis": {"fog_density": 0.0008, "fog_albedo": 0.8, "nee": True,
                    "mis": True},
    "ambient_occlusion": {"aov": "ambient_occlusion"}}


@pytest.mark.parametrize("setting", list(LIT_KNOT_SETTINGS))
def test_triangle_header_lit_trefoil_bodies(lib, setting):
    """The small trefoil (15 slabs in 2 groups) as mesh 1 behind an
    emissive sphere, so that bounces, the last segments' any-hit, NEE's
    shadow rays and the AO cast walk its groups and its balls seed them,
    in the materials, NEE and fog bodies (whose walk the card calls out of
    line) and the AOV body: the header's render against the plain
    brute-force step's, 2 steps, lit. The AO render is bit-equal; the
    bodies' renders have equal sample counts and differ by under 1e-4 of
    their values (the C library's sinf/cosf against torch's in the BSDFs
    and the bump, as in the material tests: up to 2e-5 here); a cast that
    found another hit would differ by the order of the value."""
    from l2n_tpu_torch.probes.step_ab import lit_knot
    cfg = RenderConfig(width=128, height=64, tiles_per_step=2,
                       scene_kind="triangle",
                       **LIT_KNOT_SETTINGS[setting]).validate()
    knot = load_obj(trefoil_obj(seg_u=48, seg_v=20))
    scene = lit_knot(knot)
    cam = _trefoil_view(cfg, knot)
    ha, _ = _render_triangles(cfg, scene, cam, 2, host_lib=lib)
    pa, _ = _render_triangles(cfg, scene, cam, 2)
    assert (pa[:3].max(0) > 0).mean() > 0.05
    if setting == "ambient_occlusion":
        np.testing.assert_array_equal(ha, pa)
    else:
        np.testing.assert_array_equal(ha[3], pa[3])
        np.testing.assert_allclose(ha, pa, rtol=1e-4, atol=1e-5)


ASAN_SEEDED = r"""
import ctypes, dataclasses, json, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.probes.step_ab import lit_knot
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import load_obj, torus_field_obj, trefoil_obj
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 16
lib.l2n_fallbacks_host.restype = ctypes.c_int64
cfg = RenderConfig(width=128, height=64, scene_kind="triangle",
                   **json.loads(sys.argv[2]))
cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
fallbacks = 0
# 9 and 15 slabs (a last group of 1 and of 7), two tori with balls, and
# the 15-slab knot as mesh 1 behind a light; each also with every
# inscribed sphere forged to its bound (the fallback).
for scene in (load_obj(trefoil_obj(seg_u=36, seg_v=16)),
              load_obj(trefoil_obj(seg_u=48, seg_v=20)),
              load_obj(torus_field_obj(n_tori=2, seg_u=16, seg_v=10)),
              lit_knot(load_obj(trefoil_obj(seg_u=48, seg_v=20)))):
    real = TriangleBuffers.from_scene(scene)
    verts = scene.vertices
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    vm = look_at(target + np.float32([0.35, 0.25, 1.0]) * 1.6 * radius,
                 target, np.float32([0.0, 1.0, 0.0]))
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    for buf in (real, dataclasses.replace(
            real, inner_gap=torch.zeros_like(real.inner_gap))):
        m, s = buf.slab_bounds.shape[:2]
        sched = torch.as_tensor(tile_grid(cfg))
        accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
        output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
        ip, fp = step_params(cfg, cfg.tile_count, m, cam)
        arrays = [ip, fp] + [t.numpy() for t in (
            sched, *buf.kernel_arrays(), accum, output)]
        ptrs = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:14],
                                        None, *ptrs[14:], None) == 0
        assert float(accum[3].sum()) == cfg.padded_height * cfg.padded_width
        assert float(accum[:3].max()) > 0
        fallbacks += lib.l2n_fallbacks_host()
assert fallbacks > 0
print("clean")
"""


@pytest.mark.parametrize("setting", ["pathtracing", "ambient_occlusion",
                                     "microfacet_bump_sun",
                                     "nee_mis_microfacet", "fog_nee_mis"])
def test_seeded_grouped_walk_header_memcheck_asan(asan_build, setting):
    """The memory check of the group level and the seeded walk (ROADMAP
    Queue 3 #15, #4): whole frames over trefoils of 9 and 15 slabs (a
    partial last group of 1 and of 7 slabs, never read past the mesh's
    own slabs), two tori with interior balls and the 15-slab knot behind
    a light (its bounces, any-hit and shadow rays walk the groups), with
    the packed data and with the inscribed spheres forged so that casts
    walk again; the path tracer, the ambient-occlusion cast (`occluded`)
    and the materials, NEE and fog bodies."""
    over = LIT_KNOT_SETTINGS.get(setting, {})
    _asan_render(asan_build, script=ASAN_SEEDED, args=(json.dumps(over),))
