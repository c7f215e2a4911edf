"""Next event estimation and MIS of l2n_tpu_torch against the JAX package
on the CPU.

Units, on lanes made from a numpy seed, the JAX side op by op
(jax.disable_jit): both light samplers, cone_solid_angle,
nee_contribution and nee_cone_contribution (Lambert's kd / pi and the
microfacet BSDF; fog_density 0 and 0.02) and mis_emission_weight (area
and cone). Tolerance: bit-equal, except where an input went through sin
or cos (the sampled light point, the cone's direction), on which torch's
and XLA's CPU functions differ by an ulp on a few lanes (ROADMAP Queue 3
#13): there bit-equal wherever both agree, and the exp of fog to 2 ulps.

tests/test_nee.py's closed-form gates on the port's plain path: area NEE
against kd Le (r/d)^2 (2%), cone NEE against the same closed form with the
mesh emission (3%), the fully occluded cone exactly 0 on every lane, the
triangle furnace kd Le with and without MIS (3%), and MIS against plain
NEE (5%).

The slice: the port's plain step (backend="torch") against
l2n_tpu.render.step._xla_step run op by op, the JAX hash tables carried
into the port's, with the sky off so that every lit pixel is emission or
NEE: spheres with nee, nee+mis and nee+mis+microfacet+bump, meshes with
nee and nee+mis, and the wavefront step with nee+mis. Gates: the north
star's (accum[3] equal, accum RMSE < 1e-3, output |d| > 1e-3 on fewer than
2e-3 of the values), lit coverage. And the draw budget and the wavefront
resume point equal the JAX package's for every (material mode, nee, mis).
"""

from __future__ import annotations

import functools
import math
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.maths import brdf as jbrdf
from l2n_tpu.maths import bump as jbump
from l2n_tpu.maths.sampling import procedural_color as jprocedural_color
from l2n_tpu.ops import nee as jnee
from l2n_tpu.ops import pathtrace as jpathtrace
from l2n_tpu.ops.kernels.triangle_pt import pack_mesh_blocks as jpack
from l2n_tpu.ops.scenes import sphere_intersector as jsphere_intersector
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.rng import sampler as jsampler
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths import brdf
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops import nee
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.pathtrace import trace_path, wavefront_draw_position
from l2n_tpu_torch.ops.scenes import (
    sphere_anyhit,
    sphere_intersector,
    triangle_anyhit,
    triangle_intersector,
)
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.rng import sampler as tsampler
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import build_triangle_scene


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings (tests/test_aot_cache.py scans every loaded l2n_tpu* module)."""
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


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

N = 4096


@functools.cache
def _default_spheres():
    """The default 128 spheres as the JAX scene and the port's (13, n)
    buffer of the same floats."""
    cfg = RenderConfig().validate()
    jsc = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    sc = SphereScene.from_numpy(jsc.center_x, jsc.center_y, jsc.center_z,
                                jsc.sqr_radius)
    return cfg, jsc, sc.packed()


def _unit_lanes(seed=61):
    """N vertices on the surfaces of the default spheres (their diffuse
    ones), their normals scaled to lengths 0.5 to 2, albedo, throughput,
    the view direction wo and the draws (u_pick, u1, u2)."""
    cfg, jsc, spheres = _default_spheres()
    gen = np.random.Generator(np.random.PCG64(seed))
    idx = gen.integers(0, 128, N)
    idx[idx % 16 == 0] += 1
    nv = gen.normal(size=(3, N))
    nv /= np.linalg.norm(nv, axis=0)
    c = spheres[:3].numpy().astype(np.float64)
    r = np.sqrt(spheres[3].numpy().astype(np.float64))
    h = (c[:, idx] + nv * r[idx]).astype(np.float32)
    unit_n = nv.astype(np.float32)
    nv = (nv * (0.5 + 1.5 * gen.random(N))).astype(np.float32)
    kd, tp = (gen.random((3, N), dtype=np.float32) for _ in range(2))
    wo = -unit_n * 0.6 + gen.normal(size=(3, N)) * 0.3
    wo = (wo / np.linalg.norm(wo, axis=0)).astype(np.float32)
    u = gen.random((3, N), dtype=np.float32).clip(1e-7, 1 - 1e-7)
    return dict(h=h, n=nv, unit_n=unit_n, kd=kd, tp=tp, wo=wo, u=u)


def _trig_agrees(x: np.ndarray) -> np.ndarray:
    """Lanes whose float32 sin and cos of x torch and XLA agree on."""
    xt = _t(x)
    with jax.disable_jit():
        js, jc = np.asarray(jnp.sin(_j(x))), np.asarray(jnp.cos(_j(x)))
    return (torch.sin(xt).numpy() == js) & (torch.cos(xt).numpy() == jc)


def _phi(u2):
    return ((2.0 * math.pi) * _t(u2).float()).numpy().astype(np.float32)


def test_sphere_light_sampler_matches_jax():
    """The pick (index, centre, r^2) bit-equal; the point on the sphere
    bit-equal where sin/cos of 2 pi u2 agree (over 90% of lanes), within 2
    ulps (and an ulp of sin times the radius) elsewhere."""
    cfg, jsc, spheres = _default_spheres()
    lanes = _unit_lanes()
    u = lanes["u"]
    sampler = nee.sphere_light_sampler(cfg, spheres)
    got = sampler.sample(*(_t(x) for x in u))
    cx, cy, cz, r2 = (jnp.asarray(a) for a in (
        jsc.center_x, jsc.center_y, jsc.center_z, jsc.sqr_radius))
    jls = jnee.make_sphere_light_sampler(
        128, cfg.emissive_every, lambda i: (cx[i], cy[i], cz[i], r2[i]))
    assert sampler.n_lights == jls.n_lights == 8 and sampler.kind == "area"
    with jax.disable_jit():
        want = jls(*(_j(x) for x in u))
    np.testing.assert_array_equal(_np(got.index), _np(want.index))
    np.testing.assert_array_equal(_np(got.r2), _np(want.r2))
    assert len(np.unique(_np(got.index))) == 8
    agree = _trig_agrees(_phi(u[2]))
    assert agree.mean() > 0.9
    for name in ("px", "py", "pz", "nx", "ny", "nz"):
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        np.testing.assert_array_equal(g[agree], w[agree], err_msg=name)
        np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=2e-6)


def _tri_scene(spheres_count=8, lat=8, long=4):
    cfg = RenderConfig(sphere_count=spheres_count, disc_lat=lat,
                       disc_long=long, scene_kind="triangle").validate()
    jsph = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    jscene = jtessellate(jsph, lat, long)
    scene = build_triangle_scene(compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed), lat, long)
    return cfg, jscene, scene


def test_mesh_light_bounds_are_the_jax_packs():
    """The cone sampler's bounds are the kernel's packed mesh bounds, byte
    for byte the JAX package's pack_mesh_blocks(scene)[1], and its pick is
    the JAX select-sweep's (all five outputs bit-equal)."""
    cfg, jscene, scene = _tri_scene(32, 8, 4)
    buf = TriangleBuffers.from_scene(scene)
    want = np.asarray(jpack(jscene)[1])
    got = buf.mesh_bounds.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    sampler = nee.mesh_light_sampler(cfg, buf.mesh_bounds)
    b = [jnp.asarray(want[:, i]) for i in range(4)]
    jpick = jnee.make_mesh_light_sampler(
        32, cfg.emissive_every, lambda m: tuple(c[m] for c in b))
    assert sampler.n_lights == jpick.n_lights == 2 and sampler.kind == "cone"
    u = np.random.Generator(np.random.PCG64(3)).random(N, dtype=np.float32)
    with jax.disable_jit():
        want_pick = jpick(_j(u))
    for g, w in zip(sampler.pick(_t(u)), want_pick):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_cone_solid_angle_matches_jax():
    gen = np.random.Generator(np.random.PCG64(5))
    d2 = (gen.random(N) * 400).astype(np.float32)
    r2 = (gen.random(N) * 50).astype(np.float32)
    d2[:64] = r2[:64]  # on the bound: inside
    with jax.disable_jit():
        want = jnee.cone_solid_angle(_j(d2), _j(r2))
    got = nee.cone_solid_angle(_t(d2), _t(r2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert (_np(got[1]) == -1.0).mean() > 0.05


def _brdf_pair(lanes, mode):
    """The port's and JAX's brdf_eval for the lanes (None for Lambert):
    microfacet at roughness 0.4 around the unit normal."""
    if mode == "lambert":
        return None, None
    nh = tuple(_t(x) for x in lanes["unit_n"])
    wo = tuple(_t(x) for x in lanes["wo"])
    kd = tuple(_t(x) for x in lanes["kd"])
    rough = torch.full((lanes["kd"].shape[1],), 0.4)
    jn, jwo, jkd = ([_j(x) for x in lanes[k]] for k in ("unit_n", "wo",
                                                         "kd"))

    def port(wi):
        return brdf.eval_brdf(nh, wo, wi, kd, rough)

    def oracle(lx, ly, lz):
        return jbrdf.eval_brdf(*jn, *jwo, lx, ly, lz, *jkd, _j(rough))

    return port, oracle


def _close_where_trig_agrees(got, want, agree, fog):
    g = np.stack([_np(x) for x in got])
    w = np.stack([_np(x) for x in want])
    if fog:  # exp of torch and XLA: 2 ulps
        np.testing.assert_allclose(g[:, agree], w[:, agree], rtol=2.5e-7,
                                   atol=0)
    else:
        np.testing.assert_array_equal(g[:, agree], w[:, agree])
    lit = (w.max(0) > 0)
    assert 0.05 < lit.mean() < 0.95, lit.mean()
    return g, w


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("fog", [0.0, 0.02], ids=["clear", "fog"])
@pytest.mark.parametrize("mode", ["lambert", "microfacet"])
def test_nee_contribution_matches_jax(mode, fog, mis):
    """Area NEE at N vertices on the default spheres, both sides fed the
    JAX light sample: bit-equal (fog: within 2 ulps); the shadow rays see
    the lights from some vertices and not from others."""
    cfg, jsc, spheres = _default_spheres()
    cfg = cfg.replace(fog_density=fog)
    jcfg = JRenderConfig.from_json(cfg.to_json())
    lanes = _unit_lanes()
    cx, cy, cz, r2 = (jnp.asarray(a) for a in (
        jsc.center_x, jsc.center_y, jsc.center_z, jsc.sqr_radius))
    jls = jnee.make_sphere_light_sampler(
        128, cfg.emissive_every, lambda i: (cx[i], cy[i], cz[i], r2[i]))
    port_eval, jax_eval = _brdf_pair(lanes, mode)
    h, n, kd, tp = (lanes[k] for k in ("h", "n", "kd", "tp"))
    with jax.disable_jit():
        light = jls(*(_j(x) for x in lanes["u"]))
        want = jnee.nee_contribution(
            jcfg, 8, jsphere_intersector(jsc), light, *map(_j, h),
            *map(_j, n), *map(_j, kd), *map(_j, tp), mis=mis,
            brdf_eval=jax_eval)
    tl = nee.LightSample(*(_t(_np(getattr(light, f))) for f in (
        "px", "py", "pz", "nx", "ny", "nz", "index", "r2")))
    got = nee.nee_contribution(
        cfg, 8, sphere_intersector(*spheres[:4]), tl,
        tuple(map(_t, h)), tuple(map(_t, n)), tuple(map(_t, kd)),
        tuple(map(_t, tp)), mis, port_eval)
    _close_where_trig_agrees(got, want, np.ones(N, bool), fog > 0)


@functools.cache
def _cone_lanes():
    """Vertices just outside the meshes of 4 spheres tessellated 8 x 4
    (meshes 0 and 2 the lights: emissive_every 2; the JAX sweep runs a
    Python loop over the soup), normals of lengths 0.5 to 2."""
    cfg, jscene, scene = _tri_scene(4, 8, 4)
    cfg = cfg.replace(emissive_every=2)
    buf = TriangleBuffers.from_scene(scene)
    sph = compute_spheres(4, cfg.world_size, cfg.scene_seed)
    lanes = {k: v[..., :N // 4] for k, v in _unit_lanes(67).items()}
    gen = np.random.Generator(np.random.PCG64(68))
    idx = gen.integers(0, 4, N // 4)
    idx[idx % 2 == 0] += 1
    c = np.stack([sph.center_x.numpy(), sph.center_y.numpy(),
                  sph.center_z.numpy()]).astype(np.float64)
    r = np.sqrt(sph.sqr_radius.numpy().astype(np.float64))
    lanes["h"] = (c[:, idx] + lanes["unit_n"] * r[idx] * 1.001).astype(
        np.float32)
    return cfg, jscene, buf, lanes


@functools.cache
def _cone_oracle():
    """The JAX package's intersector and cone sampler of _cone_lanes'
    scene (make_intersector: the sampler over pack_mesh_blocks' bounds)."""
    from l2n_tpu.render.step import make_intersector
    cfg, jscene, _, _ = _cone_lanes()
    jcfg = JRenderConfig.from_json(cfg.replace(nee=True).to_json())
    jisect, _, jls, _ = make_intersector(jcfg, jscene)
    return jisect, jls


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("fog", [0.0, 0.02], ids=["clear", "fog"])
@pytest.mark.parametrize("mode", ["lambert", "microfacet"])
def test_nee_cone_contribution_matches_jax(mode, fog, mis):
    """Cone NEE at N / 4 vertices just outside the meshes of 4 tessellated
    spheres, the JAX sweep over the soup against the port's: bit-equal
    wherever sin/cos of the cone's azimuth agree (fog: 2 ulps)."""
    cfg, jscene, buf, lanes = _cone_lanes()
    cfg = cfg.replace(fog_density=fog)
    jcfg = JRenderConfig.from_json(cfg.to_json())
    jisect, jls = _cone_oracle()
    sampler = nee.mesh_light_sampler(cfg, buf.mesh_bounds)
    isect = triangle_intersector(buf.soup, buf.mesh_bounds[:, 3])
    h, n, kd, tp, u = (lanes[k] for k in ("h", "n", "kd", "tp", "u"))
    port_eval, jax_eval = _brdf_pair(lanes, mode)
    with jax.disable_jit():
        want = jnee.nee_cone_contribution(
            jcfg, jls, jisect, *map(_j, u), *map(_j, h), *map(_j, n),
            *map(_j, kd), *map(_j, tp), mis=mis, brdf_eval=jax_eval)
    got = nee.nee_cone_contribution(
        cfg, sampler, isect, *map(_t, u), tuple(map(_t, h)),
        tuple(map(_t, n)), tuple(map(_t, kd)), tuple(map(_t, tp)), mis,
        port_eval)
    agree = _trig_agrees(_phi(u[2]))
    assert agree.mean() > 0.9
    _close_where_trig_agrees(got, want, agree, fog > 0)


@pytest.mark.parametrize("kind", ["area", "cone"])
def test_mis_emission_weight_matches_jax(kind):
    gen = np.random.Generator(np.random.PCG64(71))
    prev_pdf = (gen.random(N) * 0.5).astype(np.float32)
    bd = gen.normal(size=(3, N))
    bd = (bd / np.linalg.norm(bd, axis=0)).astype(np.float32)
    cur_t = (gen.random(N) * 30).astype(np.float32)
    n = (gen.normal(size=(3, N)) * 0.9).astype(np.float32)
    emis_r2 = (gen.random(N) * 9).astype(np.float32)
    bound_r2 = (gen.random(N) * 12).astype(np.float32)
    rows = _t(np.ones((4, 17), np.float32))
    sampler = nee.LightSampler(kind, rows, 16)
    with jax.disable_jit():
        want = jnee.mis_emission_weight(
            JRenderConfig(), kind, 2, _j(prev_pdf), *map(_j, bd),
            _j(cur_t), *map(_j, n), _j(emis_r2), _j(bound_r2))
    got = nee.mis_emission_weight(
        RenderConfig(), sampler, _t(prev_pdf), tuple(map(_t, bd)),
        _t(cur_t), tuple(map(_t, n)), _t(emis_r2), _t(bound_r2))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert 0.01 < (_np(want) < 0.5).mean() < 0.99


@pytest.mark.parametrize("nee_on", [False, True], ids=["off", "nee"])
@pytest.mark.parametrize("max_bounces", [1, 2, 4])
def test_draw_budget_matches_jax(max_bounces, nee_on):
    assert (tsampler.max_pairs_per_sample(max_bounces, nee_on)
            == jsampler.max_pairs_per_sample(max_bounces, nee_on))


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("mode", ["procedural", "microfacet", "disney"])
def test_wavefront_draw_position_matches_jax(mode, mis):
    """Pass B's resume point, replayed by the port on a one-lane dummy and
    by the JAX package on its scene, for NEE with and without MIS and for
    the same mode without NEE."""
    from l2n_tpu.render.step import make_intersector
    for nee_on in (False, True):
        cfg = RenderConfig(width=128, height=64, sphere_count=16,
                           material_mode=mode, nee=nee_on,
                           mis=mis and nee_on).validate()
        jcfg = JRenderConfig.from_json(cfg.to_json())
        jisect, _, jls, _ = make_intersector(
            jcfg, jcompute(16, cfg.world_size, cfg.scene_seed))
        want = jpathtrace.wavefront_draw_position(jcfg, jisect, jls)
        assert wavefront_draw_position(cfg) == tuple(want)


# ---------------------------------------------------------------------------
# tests/test_nee.py's closed-form gates on the port's plain path
# ---------------------------------------------------------------------------

def _gallery():
    """The light (index 0) r = 2 at z = 10 over a big sphere whose top sits
    at z = -1: rows (4, 2) and the (2, 3) albedo of procedural_color."""
    data = np.array([[0, 0, 10, 2.0], [0, 0, -100, 99.0]], np.float32)
    rows = np.stack([data[:, 0], data[:, 1], data[:, 2], data[:, 3] ** 2])
    return rows


def _kd1():
    with jax.disable_jit():
        return float(jprocedural_color(jnp.int32(1))[0])


def _albedo(n):
    with jax.disable_jit():
        return _t(np.stack([np.asarray(c) for c in
                            jprocedural_color(jnp.arange(n))], 1))


def _estimate(nee_on, bounces, n=100_000, mis=False, rows=None):
    """tests/test_nee.py::estimate on the port: n camera rays from (0, 0,
    3) straight down, one sample each; returns the red channel."""
    rows = _t(_gallery() if rows is None else rows)
    cfg = RenderConfig(width=8, height=8, env_mode="none",
                       max_bounces=bounces, nee=nee_on, mis=mis).validate()
    intersect = sphere_intersector(*rows)
    sampler = tsampler.ThreefrySampler(
        0, 0, torch.arange(n), torch.zeros(n, dtype=torch.int64),
        tsampler.max_pairs_per_sample(bounces, nee_on))
    z = torch.zeros(n)
    lights = nee.LightSampler("area", rows, 16) if nee_on else None
    r, _, _ = trace_path(cfg, intersect, sphere_anyhit(*rows),
                         _albedo(rows.shape[1]), sampler, z, z,
                         torch.full((n,), 3.0), z, z, torch.full((n,), -1.0),
                         nee=lights)
    return r.numpy()


def _estimate_triangle(nee_on, bounces, n=100_000, mis=False, rows=None,
                       tess=(12, 6), origin_z=3.0):
    """tests/test_nee.py::estimate_triangle on the port: the same gallery
    tessellated (the light is mesh 0), the plain brute-force sweep."""
    rows = _gallery() if rows is None else rows
    sph = SphereScene.from_numpy(*rows)
    scene = build_triangle_scene(sph, *tess)
    buf = TriangleBuffers.from_scene(scene)
    cfg = RenderConfig(width=8, height=8, env_mode="none",
                       max_bounces=bounces, nee=nee_on, mis=mis,
                       scene_kind="triangle").validate()
    intersect = triangle_intersector(buf.soup, buf.mesh_bounds[:, 3])
    sampler = tsampler.ThreefrySampler(
        0, 0, torch.arange(n), torch.zeros(n, dtype=torch.int64),
        tsampler.max_pairs_per_sample(bounces, nee_on))
    z = torch.zeros(n)
    lights = nee.mesh_light_sampler(cfg, buf.mesh_bounds) if nee_on else None
    r, _, _ = trace_path(cfg, intersect, triangle_anyhit(intersect),
                         _albedo(rows.shape[1]), sampler, z, z,
                         torch.full((n,), float(origin_z)), z, z,
                         torch.full((n,), -1.0), nee=lights)
    return r.numpy()


def test_area_nee_matches_closed_form():
    le = 8192.0 / (4 * math.pi * 4.0)
    want = _kd1() * le * (4.0 / 121.0)  # sin^2(alpha) = (r/d)^2
    assert _estimate(True, 1).mean() == pytest.approx(want, rel=0.02)


def test_cone_nee_matches_closed_form():
    """Meshes emit with r^2 = 1 (Le = scale / (4 pi)); a fine tessellation
    keeps the inscribed polyhedron's flux deficit inside the tolerance."""
    got = _estimate_triangle(True, 1, n=25_000, tess=(32, 16)).mean()
    want = _kd1() * 8192.0 / (4 * math.pi) * (4.0 / 121.0)
    assert got == pytest.approx(want, rel=0.03)


def test_cone_nee_fully_occluded_is_exactly_zero():
    """An occluder (r = 3 at z = 5) whose cone contains the light's from
    every floor point the rays reach: the estimator is 0 on every lane."""
    rows = np.array([[0, 0, 0], [0, 0, 0], [10, -100, 5],
                     [4, 99.0 ** 2, 9]], np.float32)
    got = _estimate_triangle(True, 1, n=20_000, rows=rows, origin_z=0.0)
    assert np.all(got == 0.0)


@pytest.mark.parametrize("mis", [False, True])
def test_triangle_furnace(mis):
    """A diffuse ball (mesh 1) inside a huge emissive enclosure (mesh 0)
    reflects exactly kd Le per camera ray, whatever the geometry; NEE sees
    the vertex inside the light's bound (4 pi), MIS weighs the BSDF side's
    enclosure hits."""
    rows = np.array([[0, 0], [0, 0], [0, 0], [50.0 ** 2, 2.0 ** 2]],
                    np.float32)
    got = _estimate_triangle(True, 2, n=50_000, mis=mis, rows=rows,
                             tess=(16, 8), origin_z=6.0).mean()
    want = _kd1() * 8192.0 / (4 * math.pi)
    assert got == pytest.approx(want, rel=0.03), (got, want)


def test_sphere_mis_matches_plain_nee():
    a = _estimate(True, 2).mean()
    b = _estimate(True, 2, mis=True).mean()
    assert b == pytest.approx(a, rel=0.05)


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

def _jax_tables(n: int):
    """The (n, 3) albedo and (n, 6) material tables of the JAX hash."""
    idx = jnp.arange(n)
    with jax.disable_jit():
        albedo = [np.asarray(c) for c in jprocedural_color(idx)]
        mat = [np.asarray(c) for c in (
            jbrdf.procedural_roughness(idx),
            *jbrdf.procedural_disney_params(idx),
            jbump.procedural_bump_amplitude(idx))]
    return np.stack(albedo, 1), np.stack(mat, 1).astype(np.float32)


def _view(cfg):
    """From 4 radii off the diffuse sphere nearest to an emissive one,
    toward that light, looking at the diffuse sphere and the cluster behind
    it (spheres); up close at the diffuse mesh 1 from the side of the light
    mesh 0 (meshes): the camera sees surfaces the lights fall on."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1).astype(np.float64)
    r = np.sqrt(sc.sqr_radius.numpy().astype(np.float64))
    lights = np.arange(0, cfg.sphere_count, cfg.emissive_every)
    if cfg.scene_kind == "sphere":
        diffuse = np.setdiff1d(np.arange(cfg.sphere_count), lights)
        dm = (np.linalg.norm(c[diffuse][:, None] - c[lights][None], axis=2)
              - r[lights][None])
        di, li = np.unravel_index(np.argmin(dm), dm.shape)
        j, e = diffuse[di], lights[li]
        dist = 4.0
    else:
        j, e, dist = 1, 0, 2.5
    to = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
    eye = c[j] + to * dist * r[j]
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _scenes(cfg):
    jsph = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if cfg.scene_kind == "sphere":
        scene = SphereScene.from_numpy(jsph.center_x, jsph.center_y,
                                       jsph.center_z, jsph.sqr_radius)
        return jsph, scene.with_tables(*_jax_tables(scene.count))
    jscene = jtessellate(jsph, cfg.disc_lat, cfg.disc_long)
    buf = TriangleBuffers.from_scene(build_triangle_scene(compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed), cfg.disc_lat,
        cfg.disc_long))
    return jscene, buf.with_tables(*_jax_tables(buf.albedo.shape[1]))


@functools.cache
def _oracle(cfg_json: str, steps: int):
    """The JAX oracle's (initial accum and output, final accum and output)
    after `steps` op-by-op steps: once per module and configuration."""
    cfg = RenderConfig.from_json(cfg_json)
    jcfg = JRenderConfig.from_json(cfg_json)
    jscene, _ = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    jstep = jbuild(jcfg, jscene, backend="xla")
    jst = jinit(jcfg)
    init = (np.asarray(jst.accum), np.asarray(jst.output))
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    return init, (np.asarray(jst.accum), np.asarray(jst.output))


def _parity(cfg, steps: int, min_lit: float):
    """The port's plain step against the oracle's render of the same
    configuration (the wavefront flag aside: the oracle is single-pass)."""
    (a0, o0), (ja, jo) = _oracle(cfg.replace(wavefront=False).to_json(),
                                 steps)
    _, scene = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    st = FrameState.from_numpy(a0, o0)
    for _ in range(steps):
        st = step(st, cam)
    ta, to = st.accum.numpy(), st.output.numpy()
    lit = (np.abs(ja[:3, :cfg.height, :cfg.width]).max(0) > 0).mean()
    assert lit > min_lit, f"lit coverage {lit}"
    np.testing.assert_array_equal(ta[3], ja[3])
    rmse = np.sqrt(((ta - ja) ** 2).mean())
    assert rmse < 1e-3, f"port/oracle RMSE {rmse}"
    flips = (np.abs(to - jo) > 1e-3).mean()
    assert flips < 2e-3, f"flips {flips}"
    return ta


SPHERE_CFG = RenderConfig(width=128, height=64, sphere_count=32,
                          env_mode="none", nee=True)
TRI_CFG = RenderConfig(width=128, height=32, sphere_count=4, disc_lat=4,
                       disc_long=4, scene_kind="triangle", env_mode="none",
                       emissive_every=2, nee=True)


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="nee"),
    pytest.param({"mis": True}, id="nee_mis"),
    pytest.param({"mis": True, "material_mode": "microfacet",
                  "normal_map": 0.8}, id="nee_mis_microfacet_bump")])
def test_sphere_step_matches_xla_oracle(kw):
    _parity(SPHERE_CFG.replace(**kw).validate(), 2, 0.3)


@pytest.mark.parametrize("kw", [pytest.param({}, id="nee"),
                                pytest.param({"mis": True}, id="nee_mis")])
def test_triangle_step_matches_xla_oracle(kw):
    """One step of two bounces (MIS weighs the emission that the second
    vertex's BSDF ray finds): the JAX triangle oracle op by op sweeps every
    triangle in Python."""
    _parity(TRI_CFG.replace(max_bounces=2, **kw).validate(), 1, 0.05)


def test_wavefront_step_matches_xla_oracle():
    """The wavefront step with nee+mis, its 10th ray plane carrying the
    pdf into pass B: the oracle's render of the single-pass config."""
    _parity(SPHERE_CFG.replace(mis=True, wavefront=True).validate(), 2, 0.3)


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="nee"),
    pytest.param({"mis": True}, id="nee_mis"),
    pytest.param({"mis": True, "material_mode": "microfacet",
                  "normal_map": 0.8, "spp_per_step": 2, "max_bounces": 3},
                 id="nee_mis_microfacet_bump")])
def test_wavefront_step_equals_fused_step(kw):
    """Under NEE the plain wavefront step renders the fused step's image to
    the bit: pass B goes on from pass A's direct light at the lane, so the
    sum is taken in the fused order (2 steps of the view from beside a
    light at the diffuse sphere nearest to it, 16 spheres, 8 lights)."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, nee=True, **kw).validate()
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1)
    r = np.sqrt(sc.sqr_radius.numpy())
    odd, even = np.arange(1, 16, 2), np.arange(0, 16, 2)
    dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
    oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
    j, e = odd[oi], even[ei]  # a diffuse sphere and its nearest light
    eye = c[j] + (c[e] - c[j]) / np.linalg.norm(c[e] - c[j]) * 5.0 * r[j]
    cam = Camera.from_config(cfg, look_at(
        eye.astype(np.float32), c[j].astype(np.float32),
        np.array([0.0, 1.0, 0.0], np.float32))).packed()
    accums = []
    for wavefront in (False, True):
        step = build_render_step(cfg.replace(wavefront=wavefront), sc,
                                 backend="torch")
        st = FrameState.from_numpy(
            np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32),
            np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32))
        for _ in range(2):
            st = step(st, cam)
        accums.append(st.accum.numpy())
    np.testing.assert_array_equal(accums[1], accums[0])
    assert (accums[0][:3].max(0) > 0).mean() > 0.1
