"""The port's shell visit (l2n_tpu_torch/ops/kernels/shellwalk.py, csrc/
shellwalk.cuh in csrc/triangle_pt.cuh) against the JAX package's shellwalk
(l2n_tpu/ops/kernels/shellwalk.py, run as tests/test_shellwalk.py runs it,
jit on the CPU) and against the brute-force sweep.

The JAX kernel rebuilds its windows' vertices with in-kernel sin/cos and
budgets max(2, n/1000) flips against stored geometry; the port reads the
stored rows, so its resolved lanes and the header's casts and steps agree
with the brute-force sweep bit for bit. The header is built with g++ as
tests/test_torch_csrc.py builds it (tests/torch_csrc_shim.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_csrc_shim import (  # noqa: F401 (fixtures)
    CSRC,
    _cast,
    _mixed_rays,
    _ptr,
    asan_build,
    host_params,
    lib,
)

from l2n_tpu.ops.kernels import shellwalk as jsw
from l2n_tpu.scene import build_triangle_scene as jax_build_triangle_scene
from l2n_tpu.scene import compute_spheres as jax_compute_spheres
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.maths.sampling import normalize3
from l2n_tpu_torch.ops.intersect import intersect_triangle_scene
from l2n_tpu_torch.ops.kernels import shellwalk as sw
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    shell_route,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.scene import load_obj, torus_field_obj, trefoil_obj
from l2n_tpu_torch.scene.materials import DirectionalLights, PointLights
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import build_triangle_scene


def _forget_port():
    """Drop the port's modules from sys.modules (ROADMAP Queue 3 #12:
    tests/test_aot_cache.py scans every loaded `l2n_tpu*` module); this
    file keeps its own bindings."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs (the suite's workers share
    # the machine's cores).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


DL, DJ = 16, 8
# The JAX test's scene (16 spheres in a 384 world) and the default one.
SCENES = {"s16": (16, 384.0), "s128": (128, 1024.0)}


def _scene(name):
    n, world = SCENES[name]
    return build_triangle_scene(compute_spheres(n, world, 0), DL, DJ)


_BUFFERS = {}


def _buffers(name):
    if name not in _BUFFERS:
        _BUFFERS[name] = TriangleBuffers.from_scene(_scene(name))
    return _BUFFERS[name]


def _ray_set(kind, centers, radii, n=1024):
    """tests/test_shellwalk.py's ray sets: bounce rays from 0.995 r of a
    random mesh, turned outward, started 0.01 along; or rays from 500
    units out aimed into the +-192 box."""
    if kind == "bounce":
        rng = np.random.default_rng(3)
        m0 = rng.integers(0, centers.shape[0], n)
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        o = centers[m0] + nrm * (radii[m0] * 0.995)[:, None]
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        flip = (d * nrm).sum(1) < 0
        d[flip] -= 2 * (d[flip] * nrm[flip]).sum(1, keepdims=True) * nrm[flip]
        o = o + 0.01 * d
    else:
        rng = np.random.default_rng(4)
        o = rng.normal(size=(n, 3))
        o = o / np.linalg.norm(o, axis=1, keepdims=True) * 500.0
        tgt = rng.uniform(-192, 192, (n, 3))
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


_JAX_SHELL = {}


def _jax_shell(name, centers, radii, o, d):
    """The JAX package's shell_nearest over scene `name`, jitted once per
    scene (the 128 meshes' unrolled sweep takes ~45 s to compile)."""
    if name not in _JAX_SHELL:
        riu = jsw.unit_inner_radius(DL, DJ)
        m_count = centers.shape[0]

        def fetch(m):
            return (jnp.float32(centers[m, 0]), jnp.float32(centers[m, 1]),
                    jnp.float32(centers[m, 2]), jnp.float32(radii[m]))

        _JAX_SHELL[name] = jax.jit(
            lambda *a: jsw.shell_nearest(DL, DJ, riu, m_count, fetch, *a))
    args = [jnp.asarray(x, jnp.float32)
            for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    return tuple(np.asarray(x) for x in _JAX_SHELL[name](*args))


def _port_shell(buf, o, d, stats=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*o.T, *d.T)]
    return tuple(x.numpy() for x in sw.shell_nearest(
        buf.shell, buf.shell_tris, *t, stats=stats))


def _brute(buf, o, d):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*o.T, *d.T)]
    bt, _, _, bi, bm = intersect_triangle_scene(*t, buf.soup)
    return bt.numpy(), bm.numpy(), bi.numpy()


@pytest.mark.parametrize("name", list(SCENES))
def test_detection_matches_jax(name):
    """unit_inner_radius and detect_lat_long_spheres equal the JAX
    package's floats on the same scene, and the buffers carry the shell."""
    n, world = SCENES[name]
    assert sw.unit_inner_radius(DL, DJ) == jsw.unit_inner_radius(DL, DJ)
    assert sw.unit_inner_radius(12, 6) == jsw.unit_inner_radius(12, 6)
    port = sw.detect_lat_long_spheres(_scene(name), DL, DJ)
    want = jsw.detect_lat_long_spheres(
        jax_build_triangle_scene(jax_compute_spheres(n, world, 0), DL, DJ),
        DL, DJ)
    assert port is not None and want is not None
    for a, b in zip(port, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    buf = _buffers(name)
    assert buf.shelled
    per_mesh = _per_mesh(buf)
    np.testing.assert_array_equal(per_mesh[:, :3], port[0])
    np.testing.assert_array_equal(per_mesh[:, 3], port[1])


def test_detection_rejects_non_spheres():
    """A vertex moved by 0.2 r, or the wrong disc_lat: no lat/long scene,
    in the port as in the JAX package (tests/test_shellwalk.py:110-119)."""
    scene = _scene("s16")
    radii = sw.detect_lat_long_spheres(scene, DL, DJ)[1]
    v = np.asarray(scene.vertices).copy()
    v[7] += 0.2 * radii[0]
    broken = dataclasses.replace(scene, vertices=v)
    assert sw.detect_lat_long_spheres(broken, DL, DJ) is None
    assert sw.detect_lat_long_spheres(scene, DL + 2, DJ) is None
    jscene = jax_build_triangle_scene(jax_compute_spheres(16, 384.0, 0),
                                      DL, DJ)
    jbroken = dataclasses.replace(jscene, vertices=jnp.asarray(v))
    assert jsw.detect_lat_long_spheres(jbroken, DL, DJ) is None
    assert not TriangleBuffers.from_scene(broken).shelled


def test_shell_buffers():
    """The stored rows by cell are the slot rows of the same soup
    triangles (the floats the brute-force sweep reads), with each row's
    first PAD cells repeated; other scenes and tessellations whose window
    is not proven carry no shell; the AOV gate."""
    buf = _buffers("s16")
    rows = buf.shell_tris.numpy().reshape(16, DJ, DL + sw.PAD, 2, 12)
    soup = {k: v.numpy() for k, v in buf.soup.items()}
    idx = rows[..., 9].copy().view(np.int32)
    m, j, i, k = np.meshgrid(np.arange(16), np.arange(DJ),
                             np.arange(DL + sw.PAD), np.arange(2),
                             indexing="ij")
    np.testing.assert_array_equal(idx, m * 2 * DL * DJ
                                  + 2 * (j * DL + i % DL) + k)
    for n, key in enumerate(("v1x", "v1y", "v1z", "e1x", "e1y", "e1z",
                             "e2x", "e2y", "e2z")):
        np.testing.assert_array_equal(rows[..., n], soup[key][idx])
    slots = buf.tris.numpy()
    slot_idx = slots[:, 9].copy().view(np.int32)
    where = {int(s): r for r, s in enumerate(slot_idx) if s >= 0}
    flat = rows.reshape(-1, 12)
    np.testing.assert_array_equal(
        flat, slots[[where[int(s)] for s in idx.reshape(-1)]])
    assert sw.shell_constants(DL, DJ) is not None
    assert sw.shell_constants(8, 8) is None  # the window spans half a turn
    assert sw.shell_constants(15, 8) is None
    for scene in (load_obj(torus_field_obj(n_tori=2, seg_u=16, seg_v=10)),
                  load_obj(trefoil_obj(seg_u=48, seg_v=20)),
                  build_triangle_scene(compute_spheres(4), 8, 8)):
        off = TriangleBuffers.from_scene(scene)
        assert not off.shelled and off.shell_tris.shape[0] == 0
        assert float(off.shell[0]) == 0.0
    assert buf.kernel_arrays(shell=False)[9:11] == (None, None)
    cfg = RenderConfig(scene_kind="triangle")
    assert shell_route(cfg)
    assert not shell_route(cfg.replace(aov="tex_coords"))
    assert not shell_route(cfg.replace(aov="param_uv"))
    assert shell_route(cfg.replace(aov="ambient_occlusion"))


@pytest.mark.parametrize("kind", ["bounce", "outside"])
@pytest.mark.parametrize("name", list(SCENES))
def test_shell_nearest_matches_jax(name, kind):
    """The port's shell cast against the JAX package's on the JAX test's
    ray sets: pending agrees on all but 3% of lanes (the port's windows
    are proven rather than sampled and it tries the 5th shell's entry
    before it ends a lane); where both resolve, the same mesh and t within
    1e-3 relative, but for the JAX test's budget of flips (its procedural
    trigonometry against the port's stored floats)."""
    buf = _buffers(name)
    det = sw.detect_lat_long_spheres(_scene(name), DL, DJ)
    o, d = _ray_set(kind, *det)
    jt, jm, jp = _jax_shell(name, *det, o, d)
    t, m, p = _port_shell(buf, o, d)
    assert (jp != p).mean() <= 0.03
    both = ~jp & ~p
    assert both.mean() > 0.9
    far = np.abs(jt - t) > 1e-3 * np.maximum(t, 1)
    bad = both & (((jt < 0) != (t < 0)) | ((t >= 0) & ((jm != m) | far)))
    assert bad.sum() <= max(2, o.shape[0] // 1000), f"{bad.sum()} flips"


@pytest.mark.parametrize("kind", ["bounce", "outside"])
@pytest.mark.parametrize("name", list(SCENES))
def test_shell_nearest_matches_brute_force(name, kind):
    """On every lane the port's shell cast resolves, the brute-force
    sweep's hit bit for bit: zero mismatches in t and mesh; pending
    lanes stay under 3%."""
    buf = _buffers(name)
    det = sw.detect_lat_long_spheres(_scene(name), DL, DJ)
    o, d = _ray_set(kind, *det)
    stats = {}
    t, m, p = _port_shell(buf, o, d, stats)
    bt, bm, _ = _brute(buf, o, d)
    assert p.mean() <= 0.03
    assert stats["resolved"] + stats["pending"] == stats["rays"] == len(t)
    np.testing.assert_array_equal(t[~p], bt[~p])
    np.testing.assert_array_equal(m[~p], bm[~p])


def _per_mesh(buf):
    """(M, 8) the shell buffer's per-mesh rows: cx cy cz r r_out^2
    r_in^2 0 0."""
    return buf.shell[sw.SHELL_HEAD:].reshape(-1, sw.MESH_STRIDE).numpy()


def _records(host_lib):
    n = host_lib.l2n_shell_records_host(None, None)
    rec = np.empty((n, 7), np.int32)
    lim = np.empty(n, np.float32)
    host_lib.l2n_shell_records_host(_ptr(rec), _ptr(lim))
    return rec, lim


@pytest.mark.parametrize("cast", ["nearest", "anyhit", "occluded"])
@pytest.mark.parametrize("name", list(SCENES))
def test_shell_visits_header_match_torch(lib, name, cast):
    """Each shell visit of the header's casts (L2N_NOTE_SHELL) against
    shell_window in torch on the same ray and mesh: the same kind and, for
    a window, the same cells and t_lim bit for bit; each window that
    walked the slabs too (L2N_NOTE_SHELL_SLABS) is one whose stored
    cells hold no candidate at t <= t_lim. The casts equal the
    brute-force sweep's, and windows wrap phi and reach both pole rows."""
    buf = _buffers(name)
    rays = _mixed_rays(buf, _per_mesh(buf))
    b = rays[3:]
    if cast == "occluded":
        scale = np.random.Generator(np.random.PCG64(3)).uniform(
            0.5, 1.0, rays.shape[1]).astype(np.float32)
        rays[3:] = rays[3:] * scale
        b = np.stack([x.numpy() for x in normalize3(
            *(torch.from_numpy(r) for r in rays[3:]))])
    lib.l2n_shell_stats_host(_ptr(np.zeros(4, np.int64)))
    lib.l2n_shell_log_host(1)
    t, index = _cast(lib, ["nearest", "anyhit", "occluded"].index(cast),
                     buf, rays)
    lib.l2n_shell_log_host(0)
    rec, lim = _records(lib)
    bt, _, bi = _brute(buf, rays[:3].T, rays[3:].T)
    if cast == "nearest":
        np.testing.assert_array_equal(t, bt)
        np.testing.assert_array_equal(
            index, buf.attrs.numpy()[:, 15].copy().view(np.int32)[bi]
            * (bi >= 0) - (bi < 0))
    else:
        np.testing.assert_array_equal(index.astype(bool), bt >= 0.0)
    visits = rec[rec[:, 2] < 3]
    ray, mesh = visits[:, 0].astype(np.int64), visits[:, 1].astype(np.int64)
    o = [torch.from_numpy(rays[k][ray]) for k in range(3)]
    bb = [torch.from_numpy(b[k][ray]) for k in range(3)]
    kind, i0, ni, j0, nj, _, t_lim = sw.shell_window(
        buf.shell, torch.from_numpy(mesh), *o, *bb)
    np.testing.assert_array_equal(visits[:, 2], kind.numpy())
    win = visits[:, 2] == sw.WINDOW
    for col, want in zip((3, 4, 5, 6), (i0, ni, j0, nj)):
        np.testing.assert_array_equal(visits[win, col], want.numpy()[win])
    np.testing.assert_array_equal(lim[rec[:, 2] < 3][win],
                                  t_lim.numpy()[win])
    assert win.sum() > 0.5 * len(win)
    assert ((visits[win, 3] + visits[win, 4] > DL)).any()  # wraps phi
    assert (visits[win, 5] == 0).any()  # south pole row
    assert (visits[win, 5] + visits[win, 6] == DJ).any()  # north pole row
    slabs = rec[rec[:, 2] == 3]
    if cast == "nearest" and len(slabs):
        sel = np.array([np.flatnonzero((rec[:, 0] == r) & (rec[:, 1] == m)
                                       & (rec[:, 2] == sw.WINDOW))[-1]
                        for r, m in slabs[:, :2]])
        r_, m_ = rec[sel, 0].astype(np.int64), rec[sel, 1].astype(np.int64)
        t_w, _ = sw._window_hits(
            buf.shell, buf.shell_tris, torch.from_numpy(m_),
            *(torch.from_numpy(rec[sel, c].astype(np.int64))
              for c in (3, 4, 5, 6)),
            [torch.from_numpy(rays[k][r_]) for k in range(3)],
            [torch.from_numpy(rays[k][r_]) for k in range(3, 6)])
        assert not (t_w.numpy() <= lim[sel]).any()


def _cluster_buffers():
    """Sixteen lat/long spheres of radius 9-12 on a 4 x 4 grid 26 units
    apart (centred at (100, 40, -60)), mesh 0 (emissive) among them: a
    bounce leaves one mesh and often enters a neighbour's shell."""
    if "cluster" not in _BUFFERS:
        gen = np.random.Generator(np.random.PCG64(5))
        i, k = np.divmod(np.arange(16), 4)
        order = np.array([5, 0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                          15])
        cx = 100.0 + 26.0 * (i[order] - 1.5)
        cz = -60.0 + 26.0 * (k[order] - 1.5)
        cy = 40.0 + gen.uniform(-4.0, 4.0, 16)
        r = gen.uniform(9.0, 12.0, 16)
        spheres = SphereScene.from_numpy(cx, cy, cz, r * r)
        _BUFFERS["cluster"] = TriangleBuffers.from_scene(
            build_triangle_scene(spheres, DL, DJ))
    return _BUFFERS["cluster"]


def _aimed_camera(cfg):
    """Above and in front of the cluster, looking at its centre."""
    return Camera.from_config(cfg, view_matrix=look_at(
        np.array([100.0, 110.0, 0.0], np.float32),
        np.array([100.0, 40.0, -60.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32)))


FOG = {"fog_density": 0.002, "fog_albedo": 0.8, "fog_sky_distance": 250.0}
BODIES = {
    "lambert": {},
    "ambient_occlusion": {"aov": "ambient_occlusion"},
    "materials": {"material_mode": "microfacet", "normal_map": 0.4},
    "lights": {"material_mode": "disney"},
    "nee_mis": {"nee": True, "mis": True},
    "fog_nee_mis": {"nee": True, "mis": True, **FOG},
    "tpu_hw": {"rng": "tpu_hw"},
}


def _host_step(host_lib, cfg, cam, buf, sched, accum, output, lights):
    m, s = buf.slab_bounds.shape[:2]
    ip, fp = host_params(cfg, sched.shape[0], m, cam, lights)
    rows = None if lights is None else _ptr(lights.buffer("cpu").numpy())
    arrays = [sched, *buf.kernel_arrays()]
    assert host_lib.l2n_triangle_pt_host(
        _ptr(ip), _ptr(fp), s, s * 128,
        *(_ptr(np.ascontiguousarray(a.numpy())) for a in arrays), rows,
        _ptr(accum.numpy()), _ptr(output.numpy()), None) == 0


@pytest.mark.parametrize("body", list(BODIES))
def test_shell_header_step_matches_plain(lib, body):
    """Whole header steps of a cluster of lat/long spheres (every fourth
    a light), whose casts take their shell visits (counted): bit for bit
    the header's steps with the slab walk alone (the shell buffer zeroed),
    in the Lambert, AO, materials (with the bump), explicit-light, NEE+MIS
    and fog bodies and in tpu_hw; and against triangle_pt_plain, bit for
    bit where the body draws no libm function that the host's libm and
    torch round apart (Lambert, AO), else with tests/test_torch_csrc.py's
    gates for those bodies (ROADMAP Queue 3 #13; the card holds them to
    the bit). The view is lit."""
    cfg = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                       scene_kind="triangle", spp_per_step=1, max_bounces=3,
                       emissive_every=4, **BODIES[body]).validate()
    buf = _cluster_buffers()
    assert buf.shelled
    slabs = dataclasses.replace(buf, shell=torch.zeros_like(buf.shell))
    cam = _aimed_camera(cfg).packed()
    lights = None
    if body == "lights":
        lights = ExplicitLights(None, PointLights.from_arrays(
            np.array([[100.0, 120.0, -60.0]], np.float32),
            np.array([[4e6, 3e6, 2e6]], np.float32)),
            DirectionalLights.from_arrays(
                np.array([[0.3, -1.0, 0.2]], np.float32),
                np.array([[0.5, 0.5, 0.6]], np.float32)))
    tiles = torch.as_tensor(tile_grid(cfg))
    shape = (cfg.padded_height, cfg.padded_width)
    frames = [[torch.zeros((4, *shape)), torch.zeros((3, *shape))]
              for _ in range(3)]
    stats = np.zeros(4, np.int64)
    k = cfg.effective_tiles_per_step
    for i in range(2):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        lib.l2n_shell_stats_host(_ptr(stats))
        _host_step(lib, cfg, cam, slabs, sched, *frames[1], lights)
        lib.l2n_shell_stats_host(_ptr(stats))
        assert stats.sum() == 0
        _host_step(lib, cfg, cam, buf, sched, *frames[0], lights)
        triangle_pt_plain(cfg, sched, cam, buf, *frames[2], lights=lights)
    lib.l2n_shell_stats_host(_ptr(stats))
    assert stats[1] > 500, stats  # windows
    (ha, ho), (sa, so), (pa, po) = (
        [x.numpy() for x in f] for f in frames)
    np.testing.assert_array_equal(ha, sa)
    np.testing.assert_array_equal(ho, so)
    assert (pa[:3].max(0) > 0).mean() > 0.05  # a lit frame
    # accum, as tests/test_torch_csrc.py compares it (the tonemap's powf
    # is the host's libm).
    if body in ("lambert", "ambient_occlusion", "tpu_hw"):
        np.testing.assert_array_equal(ha, pa)
        return
    np.testing.assert_array_equal(ha[3], pa[3])
    assert np.sqrt(((ha - pa) ** 2).mean()) < 1e-3
    assert (np.abs(ho - po) > 1e-3).mean() < 2e-3


ASAN_SHELL = r"""
import ctypes, sys
import numpy as np, torch
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene.spheres import SphereScene
from l2n_tpu_torch.scene.tessellate import build_triangle_scene
sys.path.insert(0, sys.argv[2])
from torch_csrc_shim import _cast, _mixed_rays, _ptr, host_params
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 18
lib.l2n_triangle_cast_host.argtypes = [i] * 4 + [p] * 15 + [ctypes.c_int64]
lib.l2n_shell_stats_host.argtypes = [p]
gen = np.random.Generator(np.random.PCG64(5))
row, col = np.divmod(np.arange(16), 4)
cy = 40.0 + gen.uniform(-4.0, 4.0, 16)
r = gen.uniform(9.0, 12.0, 16)
buf = TriangleBuffers.from_scene(build_triangle_scene(SphereScene.from_numpy(
    100.0 + 26.0 * (row - 1.5), cy, -60.0 + 26.0 * (col - 1.5), r * r), 16, 8))
per_mesh = buf.shell[64:].reshape(-1, 8).numpy()
stats = np.zeros(4, np.int64)
lib.l2n_shell_stats_host(_ptr(stats))
rays = _mixed_rays(buf, per_mesh)
for cast in range(3):
    _cast(lib, cast, buf, rays)
cfg = RenderConfig(width=128, height=64, scene_kind="triangle",
                   aov=sys.argv[3], max_bounces=3).validate()
cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
cam = Camera.from_config(cfg, view_matrix=look_at(
    np.array([100.0, 110.0, 0.0], np.float32),
    np.array([100.0, 40.0, -60.0], np.float32),
    np.array([0.0, 1.0, 0.0], np.float32))).packed()
m, s = buf.slab_bounds.shape[:2]
ip, fp = host_params(cfg, cfg.tile_count, m, cam)
shape = (cfg.padded_height, cfg.padded_width)
accum, output = torch.zeros((4, *shape)), torch.zeros((3, *shape))
arrays = [torch.as_tensor(tile_grid(cfg)), *buf.kernel_arrays()]
assert lib.l2n_triangle_pt_host(
    _ptr(ip), _ptr(fp), s, s * 128,
    *(_ptr(np.ascontiguousarray(a.numpy())) for a in arrays), None,
    _ptr(accum.numpy()), _ptr(output.numpy()), None) == 0
assert float(accum[3].sum()) == shape[0] * shape[1]
lib.l2n_shell_stats_host(_ptr(stats))
assert stats[1] > 1000 and stats[2] > 0, stats
print("clean")
"""


@pytest.mark.parametrize("aov", ["pathtracing", "ambient_occlusion"])
def test_shell_header_memcheck_asan(asan_build, aov):
    """The shell visits' loads (the shell buffer's constants and spheres,
    the stored rows of each window's cells, windows that wrap phi and
    that reach the pole rows) under AddressSanitizer (ROADMAP Queue 3
    #15): the three casts over the mixed rays, then a whole step."""
    lib_path, asan = asan_build()
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=str(CSRC.parents[1]))
    proc = subprocess.run(
        [sys.executable, "-c", ASAN_SHELL, str(lib_path),
         os.path.dirname(os.path.abspath(__file__)), aov],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
