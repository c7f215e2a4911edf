"""Host build of the CUDA kernel's per-pixel header against the plain path.

`l2n_tpu_torch/csrc/sphere_pt.cuh` holds the kernel's whole per-pixel body
as `__host__ __device__` functions. Here g++ builds it (-ffp-contract=off,
the counterpart of nvcc's -fmad=false) into a small ctypes library, the way
l2n_tpu.native builds its C++ twin, and runs it over every pixel of the
scheduled tiles. That checks the kernel's draw order, path logic and
accumulation without a card; nvcc builds the same header on the chip
(chip_smoke.py). Gates are those of tests/test_native.py's threefry
renderer test. Every build in the port's tests lives in this one file.
"""

import ctypes
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
from l2n_tpu_torch.ops.kernels.sphere_pt import _params, sphere_pt_plain
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.rng.threefry import threefry2x32
from l2n_tpu_torch.scene.spheres import compute_spheres


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

extern "C" {
int l2n_sphere_pt_host(const int32_t* ip, const float* fp,
                       const int32_t* sched, const float* spheres,
                       float* accum, float* output) {
  const l2n::SpherePtParams p = l2n::params_from_arrays(ip, fp);
  const l2n::SceneView s = l2n::scene_view(spheres, p.n_spheres);
  for (int k = 0; k < p.k; ++k)
    for (int r = 0; r < p.tile_height; ++r)
      for (int c = 0; c < p.tile_width; ++c)
        l2n::render_pixel(p, s, sched[2 * k + 1] * p.tile_height + r,
                          sched[2 * k] * p.tile_width + c, accum, output);
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
            ip, fp = _params(cfg, k, sc.count, cam)
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
