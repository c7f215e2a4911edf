"""Host build of the CUDA kernels' per-pixel headers against the plain path:
the material modes, the bump, the explicit lights, NEE and MIS, and fog,
per lane and in whole steps of the sphere, triangle and wavefront
kernels, with their ASan cases (the shim and its builds:
tests/torch_csrc_shim.py; see tests/test_torch_csrc.py).
"""

import ctypes
import sys

import numpy as np
import pytest
import torch

from torch_csrc_shim import (  # noqa: F401 (fixtures)
    _asan_render,
    _ptr,
    _scene_ptrs,
    asan_build,
    host_params,
    lib,
)

from torch_csrc_cases import (
    TRI_CFG,
    _aimed_view,
    _render_triangles,
    _tri_aimed_camera,
)

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.pathtrace import (
    count_fog_collisions,
    wavefront_draw_position,
)
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
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
    ip, fp = host_params(cfg, 1, 1, np.zeros((10, 4), np.float32))
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
    ip, fp = host_params(cfg, 1, sc.count, np.zeros((10, 4), np.float32),
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
        ip, fp = host_params(cfg, k, sc.count, cam, kl)
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
            ip, fp = host_params(cfg, k, m, cam, lights)
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
    ip, fp = host_params(cfg, k, spheres.shape[1], cam)
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
from torch_csrc_shim import host_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from l2n_tpu_torch.scene.materials import DirectionalLights, PointLights
lib = ctypes.CDLL(sys.argv[1])
p = ctypes.c_void_p
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, ctypes.c_int, ctypes.c_int] + [p] * 18
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
        ip, fp = host_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
    tcfg = cfg.replace(scene_kind="triangle").validate()
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(16),
                                                          8, 8))
    m, s = buf.slab_bounds.shape[:2]
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = host_params(tcfg, tcfg.tile_count, m, cam, lights)
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
    ip, fp = host_params(cfg, 1, sc.count, Camera.from_config(cfg).packed())
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
    ip, fp = host_params(cfg, 1, m, Camera.from_config(cfg).packed())
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
    ip, fp = host_params(cfg, 1, count, Camera.from_config(cfg).packed())
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
    ip, fp = host_params(cfg, k, spheres.shape[1], cam)
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
from torch_csrc_shim import host_params
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
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 18
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
        ip, fp = host_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
        # the wavefront passes: ray planes of exactly 10 x n_lanes
        wcfg = cfg.replace(wavefront=True)
        ip, fp = host_params(wcfg, cfg.tile_count, count, cam)
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
    ip, fp = host_params(tcfg, tcfg.tile_count, m, cam, lights)
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
    ip, fp = host_params(cfg, 1, sc.count, np.zeros((10, 4), np.float32),
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
        ip, fp = host_params(cfg, 1, sc.count, Camera.from_config(cfg).packed())
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
        ip, fp = host_params(cfg, 1, m, Camera.from_config(cfg).packed())
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
    counts = {}
    pa, po = _render_triangles(cfg, scene, cam, 2, fog_counts=counts)
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
from torch_csrc_shim import host_params
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
from l2n_tpu_torch.scene.materials import DirectionalLights, PointLights
lib = ctypes.CDLL(sys.argv[1])
p, i = ctypes.c_void_p, ctypes.c_int
lib.l2n_sphere_pt_host.argtypes = [p] * 8
lib.l2n_triangle_pt_host.argtypes = [p, p, i, i] + [p] * 18
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
        ip, fp = host_params(cfg, cfg.tile_count, count, cam, lights)
        assert lib.l2n_sphere_pt_host(*map(ptr, (
            ip, fp, sched, spheres, rows, accum, output)), None) == 0
        assert accum[:3].max() > 0
    tcfg = cfg.replace(scene_kind="triangle").validate()
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(40),
                                                          4, 4))
    m, s = buf.slab_bounds.shape[:2]
    accum = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    output = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    ip, fp = host_params(tcfg, tcfg.tile_count, m, cam, lights)
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
