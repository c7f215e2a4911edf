"""Host build of the CUDA kernels' per-pixel headers against the plain path:
the triangle walk (csrc/triangle_pt.cuh) over the small triangle configs,
every AOV, the cone-culled primaries and their ASan cases (the shim and
its builds: tests/torch_csrc_shim.py; see tests/test_torch_csrc.py).
"""

import sys

import numpy as np
import pytest
import torch

from torch_csrc_shim import (  # noqa: F401 (fixtures)
    _asan_render,
    _walk_stats,
    asan_build,
    lib,
    lib_list1,
)

from torch_csrc_cases import (
    TRI_CFG,
    _render_triangles,
    _tri_aimed_camera,
)

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.camera.camera import slab_camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.sphere_pt import visibility_table
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
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
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


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


def test_triangle_header_memcheck_asan(asan_build):
    """The memory check of the triangle traversal (ROADMAP Queue 3 #4: never
    read a slab past a mesh's count): the header built with
    AddressSanitizer renders the default 128-mesh scene and the multi-slab
    torus field, every device-side read landing in a heap buffer of exactly
    its size, through the culled primaries' lists and the per-lane walk.
    compute-sanitizer, the card's counterpart, does not run on the card's
    machine."""
    _asan_render(asan_build)


ASAN_FUSED = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.common import step_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 18
family, rng = sys.argv[2], sys.argv[3]
# 3 tiles a step of a 32-tile frame; the call's steps fused into one
# launch of all 32 tiles from offset 31, so the schedule wraps at once.
cfg = RenderConfig(width=128, height=64, tile_width=32, tile_height=8,
                   tiles_per_step=3, rng=rng, scene_kind=family).validate()
t = cfg.tile_count
sched = np.ascontiguousarray(scheduled_tiles(
    torch.as_tensor(tile_grid(cfg)), t - 1, t).numpy()).copy()
cam = Camera.from_config(cfg).packed()
st = init_frame_state(cfg)
accum, output = st.accum.numpy().copy(), st.output.numpy().copy()
state = None if st.rng_state is None else st.rng_state.numpy().copy()
if family == "sphere":
    spheres = np.ascontiguousarray(compute_spheres(128).packed().numpy())
    ip, fp = step_params(cfg, t, 128, cam)
    args = (ip, fp, sched, spheres)
    call = lambda: lib.l2n_sphere_pt_host(*map(ptr, args), None, ptr(accum),
                                          ptr(output), state if state is None
                                          else ptr(state))
else:
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(128)))
    m, s = buf.slab_bounds.shape[:2]
    ip, fp = step_params(cfg, t, m, cam)
    arrays = [np.ascontiguousarray(a.numpy()).copy()
              for a in buf.kernel_arrays()]
    call = lambda: lib.l2n_triangle_pt_host(
        ptr(ip), ptr(fp), s, s * 128, ptr(sched), *map(ptr, arrays), None,
        ptr(accum), ptr(output), state if state is None else ptr(state))
for _ in range(2):
    assert call() == 0
assert float(accum[3].sum()) == 2 * cfg.padded_height * cfg.padded_width
print("clean")
"""


@pytest.mark.parametrize("family,rng", [("sphere", "tinymt"),
                                        ("triangle", "tinymt"),
                                        ("triangle", "tpu_hw")])
def test_header_memcheck_asan_fused_schedule(asan_build, family, rng):
    """The memory check of a call's steps fused into one launch (render/
    step.py MultiStep, ROADMAP Queue 3 #15): 3 tiles a step, all 32 tiles
    of the frame in one schedule from offset 31, twice, through sphere_pt's
    and triangle_pt's headers built with AddressSanitizer, the stateful
    sampler's planes and every scene buffer a heap array of exactly its
    size."""
    _asan_render(asan_build, script=ASAN_FUSED, args=(family, rng))


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
