"""Host build of the CUDA kernels' per-pixel headers against the plain path:
the triangle walk's certain-hit seeds, slab groups and far grazing hits,
the trefoil knot, alone and behind a light in every body, and their ASan
cases (the shim and its builds: tests/torch_csrc_shim.py; see
tests/test_torch_csrc.py).
"""

import dataclasses
import functools
import json
import sys

import numpy as np
import pytest
import torch

from torch_csrc_shim import (  # noqa: F401 (fixtures)
    _asan_render,
    _cast,
    asan_build,
    lib,
)

from torch_csrc_cases import _render_triangles

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    certain_hit_seed,
    takes_fallback,
)
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
from torch_csrc_shim import host_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.probes.step_ab import lit_knot
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import load_obj, torus_field_obj, trefoil_obj
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 18
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
        ip, fp = host_params(cfg, cfg.tile_count, m, cam)
        arrays = [ip, fp] + [t.numpy() for t in (
            sched, *buf.kernel_arrays(), accum, output)]
        ptrs = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
        assert lib.l2n_triangle_pt_host(*ptrs[:2], s, s * 128, *ptrs[2:16],
                                        None, *ptrs[16:], None) == 0
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
