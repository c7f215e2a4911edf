"""Host build of the CUDA kernels' per-pixel headers against the plain path:
the path body, the samplers, the sphere scene, the wavefront passes and
the probes.

`l2n_tpu_torch/csrc/pathtrace.cuh` holds the kernels' whole per-pixel path
body as `__host__ __device__` functions, `sphere_pt.cuh` and
`triangle_pt.cuh` the two scenes' traversals. Here g++ builds them
(-ffp-contract=off, the counterpart of nvcc's -fmad=false) into a small
ctypes library, the way l2n_tpu.native builds its C++ twin, and runs them
over every pixel of the scheduled tiles. That checks the kernels' draw
order, path logic, traversal and accumulation without a card; nvcc builds
the same headers on the chip (chip_smoke.py). Gates are those of
tests/test_native.py's threefry renderer test and of
tests/test_kernels.py::TestTriangleKernel. The builds and the shim live
in tests/torch_csrc_shim.py, the render helpers these files share in
tests/torch_csrc_cases.py; the triangle walk's cases are in
tests/test_torch_csrc_triangle.py and test_torch_csrc_seeded.py, the
materials, lights, NEE and fog bodies' in test_torch_csrc_materials.py.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_csrc_shim import (  # noqa: F401 (fixtures)
    CSRC,
    _asan_render,
    _ptr,
    asan_build,
    host_params,
    lib,
)

from torch_csrc_cases import (
    TRI_CFG,
    _aimed_view,
    _inside_view,
    _render,
    _tri_aimed_camera,
)

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.camera.camera import slab_camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.envlight import SUN_S, mandelbrot_le, sun_le
from l2n_tpu_torch.ops.intersect import intersect_sphere_scene
from l2n_tpu_torch.ops.kernels.common import RNG_CODES
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits_plain
from l2n_tpu_torch.ops.kernels.sphere_pt import visibility_table
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.kernels.wavefront import (
    wavefront_pass_a_plain,
    wavefront_pass_b_plain,
    wavefront_pass_c_plain,
)
from l2n_tpu_torch.ops.pathtrace import generate_rays, wavefront_draw_position
from l2n_tpu_torch.probes import onehot_recovery, sweep_variants
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.rng import philox, tauslcg, tinymt
from l2n_tpu_torch.rng.state import init_tauslcg_states, init_tinymt_states
from l2n_tpu_torch.rng.threefry import threefry2x32
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
    ip, fp = host_params(cfg, 1, 1, cam)
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
    ip, fp = host_params(cfg, 1, 2, Camera.from_config(cfg).packed())
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
    ip, fp = host_params(cfg, cfg.tile_count, n,
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
    ip, fp = host_params(cfg, k, sc.count, cam)
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


ASAN_WAVEFRONT = r"""
import ctypes, sys
import numpy as np
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from torch_csrc_shim import host_params
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
    ip, fp = host_params(cfg, cfg.tile_count, count,
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


ASAN_CAMERA = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from torch_csrc_shim import host_params
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 18
ptr = lambda a: ctypes.c_void_p(None if a is None else a.ctypes.data)
floats = int(sys.argv[2])  # of the camera block the parameters hold
base = RenderConfig(width=64, height=32, tile_width=8, tile_height=8,
                    sphere_count=16, emissive_every=2, disc_lat=6,
                    disc_long=4)
spheres = compute_spheres(16)
packed = spheres.packed().numpy()
buf = TriangleBuffers.from_scene(build_triangle_scene(spheres, 6, 4))
for kind in ("sphere", "triangle"):
    for ray_gen in ("fovy", "viewproj"):
        cfg = base.replace(scene_kind=kind, ray_gen=ray_gen).validate()
        cfg = cfg.replace(tiles_per_step=cfg.tile_count)
        sched = np.ascontiguousarray(tile_grid(cfg), np.int32)
        accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
        output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
        n = 16 if kind == "sphere" else buf.slab_bounds.shape[0]
        ip, fp = host_params(cfg, cfg.tile_count, n,
                             Camera.from_config(cfg).packed())
        # the step's floats, then the camera, in an allocation of their own
        fp = np.array(fp[:fp.size - 40 + floats])
        if kind == "sphere":
            rc = lib.l2n_sphere_pt_host(*map(ptr, (
                ip, fp, sched, packed, None, accum, output, None)))
        else:
            m, s = buf.slab_bounds.shape[:2]
            rc = lib.l2n_triangle_pt_host(
                ptr(ip), ptr(fp), s, s * 128, ptr(sched),
                *[ptr(a.numpy()) for a in buf.kernel_arrays()], None,
                ptr(accum), ptr(output), None)
        assert rc == 0
        assert float(accum[3].sum()) == cfg.padded_height * cfg.padded_width
print("clean")
"""


@pytest.mark.parametrize("floats", [40, 37])
def test_camera_block_memcheck_asan(asan_build, floats):
    """The camera read from its buffer (PtParams::cam, the host build of
    the block the card stages in constant memory) under AddressSanitizer:
    a whole-frame step of each family, in each camera form, whose camera
    block ends its allocation. With all 40 floats the run is clean; cut
    to 37 (the fovy ray reads float 37, tan(fovy / 2)) ASan reports the
    read past the buffer's end, so the case sees what the kernels read."""
    lib_path, asan = asan_build()
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([str(CSRC.parents[1]),
                                           os.path.dirname(__file__)]))
    proc = subprocess.run([sys.executable, "-c", ASAN_CAMERA, str(lib_path),
                           str(floats)], env=env, capture_output=True,
                          text=True, timeout=300)
    if floats == 40:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.strip().endswith("clean")
    else:
        assert proc.returncode != 0
        assert "heap-buffer-overflow" in proc.stderr, proc.stderr[-3000:]


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
            ip, fp = host_params(cfg, k, m, cam)
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
