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

from l2n_tpu.config import RenderConfig
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.envlight import mandelbrot_le
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
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
#include "sphere_pt.cuh"
#include "triangle_pt.cuh"

template <class Scene>
static void render_tiles(const l2n::PtParams& p, const Scene& s,
                         const int32_t* sched, float* accum, float* output) {
  for (int k = 0; k < p.k; ++k)
    for (int r = 0; r < p.tile_height; ++r)
      for (int c = 0; c < p.tile_width; ++c)
        l2n::render_pixel(p, s, sched[2 * k + 1] * p.tile_height + r,
                          sched[2 * k] * p.tile_width + c, accum, output);
}

extern "C" {
int l2n_sphere_pt_host(const int32_t* ip, const float* fp,
                       const int32_t* sched, const float* spheres,
                       float* accum, float* output) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  render_tiles(p, l2n::scene_view(spheres, p.n_scene), sched, accum, output);
  return 0;
}
int l2n_triangle_pt_host(const int32_t* ip, const float* fp, int n_slabs,
                         int tpad, const int32_t* sched,
                         const float* mesh_bounds, const int32_t* slab_count,
                         const float* slab_bounds, const float* sub_bounds,
                         const float* tris, const float* attrs,
                         const float* albedo, float* accum, float* output) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const int m = p.n_scene;
  const l2n::TriSceneView s{m, n_slabs, tpad, mesh_bounds, slab_count,
                            slab_bounds, sub_bounds, tris, attrs, albedo,
                            albedo + m, albedo + 2 * m};
  render_tiles(p, s, sched, accum, output);
  return 0;
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
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "shim.cpp").write_text(SHIM)
    out = d / "libsphere_pt_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", f"-I{CSRC}", str(d / "shim.cpp"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.l2n_sphere_pt_host.argtypes = [p] * 6
    lib.l2n_sphere_pt_host.restype = ctypes.c_int
    lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 10
    lib.l2n_triangle_pt_host.restype = ctypes.c_int
    lib.l2n_threefry_host.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                      p, p, p, p, ctypes.c_int64]
    lib.l2n_mandelbrot_host.argtypes = [p, p, ctypes.c_int64]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


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


def _render(cfg, cam, steps, host_lib=None):
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            sphere_pt_plain(cfg, sched, cam, spheres, accum, output)
        else:
            ip, fp = step_params(cfg, k, sc.count, cam)
            s_np, sp_np = sched.numpy(), spheres.numpy()
            a_np, o_np = accum.numpy(), output.numpy()
            assert host_lib.l2n_sphere_pt_host(
                _ptr(ip), _ptr(fp), _ptr(s_np), _ptr(sp_np), _ptr(a_np),
                _ptr(o_np)) == 0
    return accum.numpy(), output.numpy()


@pytest.mark.parametrize("case", ["aimed", "default"])
def test_header_matches_plain_step(lib, case):
    if case == "aimed":
        cfg = RenderConfig(width=128, height=64, sphere_count=16,
                           emissive_every=2).validate()
        view = _aimed_view(cfg)
    else:
        cfg = RenderConfig(width=128, height=64, sphere_count=128,
                           tiles_per_step=2).validate()
        view = None
    cam = Camera.from_config(cfg, view).packed()
    ha, ho = _render(cfg, cam, 4, host_lib=lib)
    pa, po = _render(cfg, cam, 4)
    if case == "aimed":
        assert (pa[:3].max(0) > 0).mean() > 0.3  # a lit frame
    assert (pa[3] > 0).all()
    np.testing.assert_array_equal(ha[3], pa[3])
    rmse = np.sqrt(((ha - pa) ** 2).mean())
    assert rmse < 1e-3, f"host header / plain RMSE {rmse}"
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


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
            *(_ptr(a.numpy()) for a in arrays)) == 0
    return accum.numpy(), output.numpy()


@pytest.mark.parametrize("aov", ["pathtracing", "tex_coords", "param_uv"])
def test_triangle_header_matches_plain_step(lib, aov):
    """The kernel's bound traversal (mesh -> slab -> sub-cluster) against
    the plain brute-force sweep on the aimed small config, 2 steps; gates
    of tests/test_kernels.py:125-151, bit-equality expected."""
    cfg = TRI_CFG.replace(aov=aov)
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count,
                                                 cfg.world_size,
                                                 cfg.scene_seed),
                                 cfg.disc_lat, cfg.disc_long)
    cam = _tri_aimed_camera(cfg).packed()
    ha, ho = _render_triangles(cfg, scene, cam, 2, host_lib=lib)
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
from l2n_tpu.config import RenderConfig
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import (build_triangle_scene, compute_spheres,
                                 load_obj, torus_field_obj)
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 10
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
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:]) == 0
    assert float(accum[3].sum()) == 2 * cfg.padded_height * cfg.padded_width
print("clean")
"""


def test_triangle_header_memcheck_asan(tmp_path):
    """The memory check of the triangle traversal (ROADMAP Queue 3 #4: never
    read a slab past a mesh's count): the header built with
    AddressSanitizer renders the default 128-mesh scene and the multi-slab
    torus field, every device-side read landing in a heap buffer of exactly
    its size. compute-sanitizer, the card's counterpart, does not run on the
    card's machine."""
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
                    "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(tmp_path / "shim.cpp"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=str(CSRC.parents[1]))
    proc = subprocess.run([sys.executable, "-c", ASAN_RENDER, str(lib_path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
