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
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.envlight import mandelbrot_le
from l2n_tpu_torch.ops.kernels.common import RNG_CODES, step_params
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits_plain
from l2n_tpu_torch.ops.kernels.sphere_pt import (
    sphere_pt_plain,
    visibility_table,
)
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.kernels.wavefront import (
    wavefront_pass_a_plain,
    wavefront_pass_b_plain,
    wavefront_pass_c_plain,
)
from l2n_tpu_torch.ops.pathtrace import wavefront_draw_position
from l2n_tpu_torch.probes import onehot_recovery, sweep_variants
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.rng import philox, tauslcg, tinymt
from l2n_tpu_torch.rng.state import init_tauslcg_states, init_tinymt_states
from l2n_tpu_torch.rng.threefry import threefry2x32
from l2n_tpu_torch.scene import load_obj, torus_field_obj
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
    yield
    _forget_port()


CSRC = Path(__file__).resolve().parents[1] / "l2n_tpu_torch" / "csrc"

SHIM = r"""
#include <cstdint>
#include <vector>
// Each walk's scans: how many, how many overflowed the per-lane list, and
// the longest list (the kernels define no hook).
static int64_t g_scans = 0, g_overflows = 0, g_longest = 0;
#define L2N_NOTE_SCAN(cnt, more) \
  (++g_scans, g_overflows += (more), \
   g_longest = (cnt) > g_longest ? (cnt) : g_longest)
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
// with the sampler instantiation the mode code picks (as the entry points).
struct RenderTiles {
  template <class Rng, class Scene>
  static int run(l2n::PtParams p, Scene s, const int32_t* sched,
                 float* accum, float* output, uint32_t* rng_state) {
    TileLists lists;
    for (int k = 0; k < p.k; ++k) {
      const Scene ts = for_tile(p, s, sched[2 * k], sched[2 * k + 1], lists);
      for (int r = 0; r < p.tile_height; ++r)
        for (int c = 0; c < p.tile_width; ++c)
          l2n::render_pixel<Rng>(p, ts, sched[2 * k + 1] * p.tile_height + r,
                                 sched[2 * k] * p.tile_width + c, accum,
                                 output, rng_state);
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

struct PassA {
  template <class Rng>
  static int run(l2n::PtParams p, const int32_t* sched, const float* spheres,
                 const float* accum, l2n::PassALanes out, int32_t* n_alive) {
    const l2n::SceneView s = l2n::scene_view(spheres, p.n_scene);
    TileLists lists;
    *n_alive = 0;
    SerialAppend append{n_alive};
    for (int k = 0; k < p.k; ++k) {
      const l2n::SceneView ts = for_tile(p, s, sched[2 * k], sched[2 * k + 1],
                                         lists);
      for (int si = 0; si < p.spp; ++si)
        for (int r = 0; r < p.tile_height; ++r)
          for (int c = 0; c < p.tile_width; ++c)
            l2n::wavefront_pass_a_sample<Rng>(p, ts, k, si, r, c, sched,
                                              accum, out, append);
    }
    return 0;
  }
};

// Pass B over the first n_alive slots, each ray's sweeps split into
// `group` parts as a group of lanes of the kernel splits them, over the
// packed spheres the kernel stages.
struct PassB {
  template <class Rng, int G>
  static void slots(const l2n::PtParams& p, const l2n::SceneView& s,
                    int next_pair, int has_spare, const int32_t* n_alive,
                    const float* rays, const int32_t* meta, float* back) {
    std::vector<l2n::Sphere4> packed(s.n);
    for (int i = 0; i < s.n; ++i)
      packed[i] = l2n::Sphere4{s.cx[i], s.cy[i], s.cz[i], s.r2[i]};
    const l2n::GroupScene<G> gs{s, packed.data(), 0, 0u};
    for (size_t slot = 0; slot < static_cast<size_t>(n_alive[0]); ++slot)
      l2n::wavefront_pass_b_slot<Rng>(p, gs, next_pair, has_spare != 0, slot,
                                      l2n::lane_count(p), rays, meta, back,
                                      true);
  }
  template <class Rng>
  static int run(l2n::PtParams p, int group, int next_pair, int has_spare,
                 const int32_t* n_alive, const float* spheres,
                 const float* rays, const int32_t* meta, float* back) {
    const l2n::SceneView s = l2n::scene_view(spheres, p.n_scene);
    switch (group) {
      case 1:
        slots<Rng, 1>(p, s, next_pair, has_spare, n_alive, rays, meta, back);
        return 0;
      case l2n::kMaxGroup:
        slots<Rng, l2n::kMaxGroup>(p, s, next_pair, has_spare, n_alive, rays,
                                   meta, back);
        return 0;
    }
    return -2;
  }
};

extern "C" {
int l2n_sphere_pt_host(const int32_t* ip, const float* fp,
                       const int32_t* sched, const float* spheres,
                       float* accum, float* output, uint32_t* rng_state) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_rng<RenderTiles>(
      p.rng, p, l2n::scene_view(spheres, p.n_scene), sched, accum, output,
      rng_state);
}
int l2n_triangle_pt_host(const int32_t* ip, const float* fp, int n_slabs,
                         int tpad, const int32_t* sched,
                         const float* mesh_bounds, const int32_t* slab_count,
                         const float* slab_bounds, const float* sub_bounds,
                         const float* tris, const float* attrs,
                         const float* albedo, float* accum, float* output,
                         uint32_t* rng_state) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const int m = p.n_scene;
  const l2n::TriSceneView s{m,          n_slabs, tpad,   mesh_bounds,
                              slab_count, slab_bounds, sub_bounds, tris,
                              attrs,      albedo,  albedo + m,
                              albedo + 2 * m};
  return l2n::dispatch_rng<RenderTiles>(p.rng, p, s, sched, accum, output,
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
void l2n_philox_bits_host(uint32_t k0, uint32_t k1, int k, int h,
                          uint32_t* out) {
  const size_t per_draw = static_cast<size_t>(h) * 128;
  for (size_t i = 0; i < static_cast<size_t>(k) * per_draw; ++i)
    out[i] = l2n::philox_bits_word(k0, k1, static_cast<uint32_t>(i % per_draw),
                                   static_cast<uint32_t>(i / per_draw));
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
int l2n_wavefront_pass_a_host(const int32_t* ip, const float* fp,
                              const int32_t* sched, const float* spheres,
                              const float* accum, float* col, float* back,
                              float* rays, int32_t* meta, int32_t* n_alive) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_counter_rng<PassA>(
      p.rng, p, sched, spheres, accum, l2n::PassALanes{col, back, rays, meta},
      n_alive);
}
int l2n_wavefront_pass_b_host(const int32_t* ip, const float* fp, int group,
                              int next_pair, int has_spare,
                              const int32_t* n_alive, const float* spheres,
                              const float* rays, const int32_t* meta,
                              float* back) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_counter_rng<PassB>(p.rng, p, group, next_pair,
                                          has_spare, n_alive, spheres, rays,
                                          meta, back);
}
int l2n_group_size_host(int64_t alive, int64_t threads) {
  return l2n::group_size(alive, threads);
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
    lib.l2n_sphere_pt_host.argtypes = [p] * 7
    lib.l2n_sphere_pt_host.restype = ctypes.c_int
    lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 11
    lib.l2n_triangle_pt_host.restype = ctypes.c_int
    lib.l2n_visibility_host.argtypes = [p, p, p, p, ctypes.c_int, p]
    lib.l2n_walk_stats_host.argtypes = [p]
    lib.l2n_block_pixel_host.argtypes = [ctypes.c_int, ctypes.c_int, p]
    u32 = ctypes.c_uint32
    lib.l2n_philox_host.argtypes = [u32, u32, p, p, ctypes.c_int64]
    lib.l2n_philox_bits_host.argtypes = [u32, u32, ctypes.c_int,
                                         ctypes.c_int, p]
    lib.l2n_stateful_draws_host.argtypes = [ctypes.c_int, p, ctypes.c_int64,
                                            ctypes.c_int, p]
    lib.l2n_threefry_host.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                      p, p, p, p, ctypes.c_int64]
    lib.l2n_mandelbrot_host.argtypes = [p, p, ctypes.c_int64]
    i = ctypes.c_int
    lib.l2n_wavefront_pass_a_host.argtypes = [p] * 10
    lib.l2n_wavefront_pass_b_host.argtypes = [p, p, i, i, i, p, p, p, p, p]
    lib.l2n_group_size_host.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.l2n_wavefront_pass_c_host.argtypes = [p] * 7
    i64 = ctypes.c_int64
    lib.l2n_sweep_lanes_host.argtypes = [i, p, p, p, i, i64, i, p, p]
    lib.l2n_onehot_lanes_host.argtypes = [i, p, p, i, p, i64, p]
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
                _ptr(ip), _ptr(fp), _ptr(s_np), _ptr(sp_np), _ptr(a_np),
                _ptr(o_np), None if planes is None else _ptr(planes.numpy())
            ) == 0
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


@pytest.mark.parametrize("case", ["aimed", "default", "inside"])
def test_header_matches_plain_step(lib, case):
    """The kernels' per-pixel body with their cone-culled primaries (the
    tile's visible list and its hoisted origin terms, csrc/cull.cuh) against
    the plain step, which sweeps every sphere: the aimed small scene, the
    default 128 spheres, and the eye inside an emissive sphere."""
    if case == "aimed":
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
    if case != "default":
        assert (pa[:3].max(0) > 0).mean() > 0.3  # a lit frame
    assert (pa[3] > 0).all()
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


@pytest.mark.parametrize("case", ["default_spheres", "default_meshes",
                                  "inside"])
def test_visibility_header_matches_plain(lib, case):
    """csrc/cull.cuh's table (the kernels' per-tile visible list, built here
    serially with the same per-sphere test) equals the plain
    visibility_table on every tile of the 1280x720 frame: the default
    spheres, the default triangle scene's mesh bounds, and the eye inside a
    sphere."""
    cfg = RenderConfig().validate()
    if case == "default_meshes":
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
        bounds = TriangleBuffers.from_scene(scene).mesh_bounds.T.contiguous()
    else:
        bounds = compute_spheres(cfg.sphere_count, cfg.world_size,
                                 cfg.scene_seed).packed()[:4].contiguous()
    view = _inside_view(cfg, 5) if case == "inside" else None
    cam = Camera.from_config(cfg, view).packed()
    sched = torch.as_tensor(tile_grid(cfg))
    n = bounds.shape[1]
    ip, fp = step_params(cfg, cfg.tile_count, n, cam)
    got = np.empty((cfg.tile_count, n + 1), np.int32)
    lib.l2n_visibility_host(_ptr(ip), _ptr(fp), _ptr(sched.numpy()),
                            _ptr(bounds.numpy()), n, _ptr(got))
    want = visibility_table(cfg, bounds, cam, sched).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1:1 + w[0]], w[1:1 + w[0]])
    assert 0 < want[:, 0].max() and want[:, 0].mean() < n
    if case == "inside":
        assert all(5 in w[1:1 + w[0]] for w in want)


@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2, "max_bounces": 3},
                                   {"max_bounces": 1}, {"rng": "tpu_hw"},
                                   {"sphere_count": 13}],
                         ids=["reference", "spp2_bounces3", "bounces1",
                              "tpu_hw", "spheres13"])
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
                                            a.meta, h_backs[-1]))) == 0
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
        arrays = [sched, buf.mesh_bounds, buf.slab_count, buf.slab_bounds,
                  buf.sub_bounds, buf.tris, buf.attrs, buf.albedo, accum,
                  output]
        assert host_lib.l2n_triangle_pt_host(
            _ptr(ip), _ptr(fp), s, s * 128,
            *(_ptr(a.numpy()) for a in arrays), None) == 0
    return accum.numpy(), output.numpy()


@pytest.mark.parametrize("aov", ["pathtracing", "tex_coords", "param_uv"])
def test_triangle_header_matches_plain_step(lib, aov):
    """The kernel's bound traversal (the culled primaries, then per lane
    its entered meshes front to back, mesh -> slab -> sub-cluster) against
    the plain brute-force sweep on the aimed small config, 2 steps; gates
    of tests/test_kernels.py:125-151, bit-equality expected."""
    cfg = TRI_CFG.replace(aov=aov)
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count,
                                                 cfg.world_size,
                                                 cfg.scene_seed),
                                 cfg.disc_lat, cfg.disc_long)
    cam = _tri_aimed_camera(cfg).packed()
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
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 11
cfg = RenderConfig(width=128, height=64, scene_kind="triangle").validate()
cfg = cfg.replace(tiles_per_step=cfg.tile_count)
for scene in (build_triangle_scene(compute_spheres(128)),
              load_obj(torus_field_obj())):
    buf = TriangleBuffers.from_scene(scene)
    m, s = buf.slab_bounds.shape[:2]
    sched = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    ip, fp = step_params(cfg, cfg.tile_count, m, Camera.from_config(cfg).packed())
    arrays = [ip, fp] + [t.numpy() for t in (
        sched, buf.mesh_bounds, buf.slab_count, buf.slab_bounds,
        buf.sub_bounds, buf.tris, buf.attrs, buf.albedo, accum, output)]
    ptrs = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
    for _ in range(2):
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:],
                                        None) == 0
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
lib.l2n_wavefront_pass_b_host.argtypes = [p, p, i, i, i, p, p, p, p, p]
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
                *map(ptr, (n_alive, spheres, rays, meta, b))) == 0
            assert not np.isnan(b).any() and (b[:, dead] == 0).all()
        accum[3] += cfg.spp_per_step
print("clean")
"""


def test_wavefront_header_memcheck_asan(tmp_path):
    """The memory check of the wavefront passes: the header built with
    AddressSanitizer runs passes A and B on two whole-frame steps of the
    default 128-sphere scene and of 100 spheres (pass B's groups of 8 end
    on a partial round) at 2 spp, into
    slot and lane arrays of exactly
    n_lanes entries each, so a slot written past n_lanes is caught; every
    lane's back is written exactly once, by pass A (the dead lanes, 0) or by
    pass B (each survivor's lane, which the slots name once)."""
    _asan_render(tmp_path, script=ASAN_WAVEFRONT)


def test_triangle_header_memcheck_asan(tmp_path):
    """The memory check of the triangle traversal (ROADMAP Queue 3 #4: never
    read a slab past a mesh's count): the header built with
    AddressSanitizer renders the default 128-mesh scene and the multi-slab
    torus field, every device-side read landing in a heap buffer of exactly
    its size, through the culled primaries' lists and the per-lane walk.
    compute-sanitizer, the card's counterpart, does not run on the card's
    machine."""
    _asan_render(tmp_path)


def test_triangle_header_memcheck_asan_list_overflow(tmp_path):
    """The same memory check with a two-entry per-lane mesh list, so the
    walk's chunked rescans run (ROADMAP Queue 3 #15)."""
    _asan_render(tmp_path, "-DL2N_LANE_LIST=2")


def _asan_render(tmp_path, *defines, script=ASAN_RENDER):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    asan = subprocess.run([cxx, "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not Path(asan).is_file():
        pytest.skip("no AddressSanitizer runtime")
    (tmp_path / "shim.cpp").write_text(SHIM)
    lib_path = tmp_path / "libtriangle_asan.so"
    subprocess.run([cxx, "-O1", "-g", "-fsanitize=address",
                    "-fno-omit-frame-pointer", "-ffp-contract=off",
                    "-std=c++17", "-shared", "-fPIC", *defines, f"-I{CSRC}",
                    str(tmp_path / "shim.cpp"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=str(CSRC.parents[1]))
    proc = subprocess.run([sys.executable, "-c", script, str(lib_path)],
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


def test_philox_bits_header_matches_plain(lib):
    out = np.empty((4, 256, 128), np.uint32)
    lib.l2n_philox_bits_host(0xBEEF, 7, 4, 256, _ptr(out))
    want = philox_bits_plain(torch.tensor([0xBEEF, 7], dtype=torch.int32))
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


def test_triangle_header_matches_plain_step_tinymt(lib):
    """The triangle traversal with the TinyMT sampler, 2 steps: accum and
    the state planes bit-equal (tests/test_kernels.py:125-151's gates)."""
    cfg = TRI_CFG.replace(rng="tinymt")
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
            arrays = [sched, buf.mesh_bounds, buf.slab_count, buf.slab_bounds,
                      buf.sub_bounds, buf.tris, buf.attrs, buf.albedo, accum,
                      output, planes]
            assert lib.l2n_triangle_pt_host(
                _ptr(ip), _ptr(fp), s, s * 128,
                *(_ptr(a.numpy()) for a in arrays)) == 0
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
