"""Homogeneous fog of l2n_tpu_torch against the JAX package on the CPU.

Units, on lanes made from a numpy seed, the JAX side op by op
(jax.disable_jit): the collision sampling (_fog_collision's decision and
t_fog), the fog vertex's isotropic direction, weight and Russian roulette
and the emission_ok transitions of its scatter (with and without NEE and
MIS), the full MIS weight of emission found after a fog vertex
(_resolve_vertex), the explicit lights' Beer-Lambert factors, and the draw
budget at every site of the port (the plain step's samplers, the kernels'
parameter block, the wavefront resume replay), an ambient-occlusion render
included. Tolerance: bit-equal, except where an input went through log,
exp, sin or cos, whose float32 results torch's and XLA's CPU functions
differ on by an ulp on a few lanes (ROADMAP Queue 3 #13): there bit-equal
wherever both agree, within 2 ulps elsewhere.

tests/test_fog.py's closed forms and agreements on the port's plain path:
Beer-Lambert attenuation of an emissive sphere at two densities (2%),
scattering keeps more energy than absorption, the sky attenuates by
exp(-sigma R_sky) (5%), NEE and MIS agree with BSDF sampling and with each
other under fog (5%), the full weight after a fog vertex carries the
fog-only light paths (8%), and fog_density 0 is bit-identical to no fog.

The slice: the port's plain step against l2n_tpu.render.step._xla_step run
op by op (spheres: fog at max_bounces 1 and 2, fog+nee, fog+nee+mis;
meshes: fog+nee+mis), the JAX hash tables carried into the port's, with
the north star's gates (accum[3] equal, accum RMSE < 1e-3, output |d| >
1e-3 on fewer than 2e-3 of the values), lit coverage and a collision
share (counted on the plain path). Every oracle render is built once per
module.
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
from l2n_tpu.ops import pathtrace as jpathtrace
from l2n_tpu.ops.lights import ExplicitLights as JExplicitLights
from l2n_tpu.ops.lights import (
    explicit_light_contribution as jexplicit_light_contribution,
)
from l2n_tpu.ops.scenes import sphere_intersector as jsphere_intersector
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.render.step import make_intersector as jmake_intersector
from l2n_tpu.rng import sampler as jsampler
from l2n_tpu.scene import materials as jmaterials
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops import nee
from l2n_tpu_torch.ops import pathtrace
from l2n_tpu_torch.ops.fog import fog_directional_transmittance
from l2n_tpu_torch.ops.kernels import common
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import (
    ExplicitLights,
    explicit_light_contribution,
)
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.rng import sampler as tsampler
from l2n_tpu_torch.scene import materials
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


def _ulps(got, want) -> np.ndarray:
    """Float32 distance in ulps of same-signed values."""
    g = np.ascontiguousarray(got, np.float32).view(np.int32).astype(np.int64)
    w = np.ascontiguousarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(g - w)


def _trig_agrees(x: np.ndarray) -> np.ndarray:
    """Lanes whose float32 sin and cos of x torch and XLA agree on."""
    xt = _t(x)
    with jax.disable_jit():
        js, jc = np.asarray(jnp.sin(_j(x))), np.asarray(jnp.cos(_j(x)))
    return (torch.sin(xt).numpy() == js) & (torch.cos(xt).numpy() == jc)


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


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

N = 4096
SIGMA = 0.002


def _samplers(max_bounces=2, nee_on=False, seed=7):
    """The port's and JAX's threefry samplers of N lanes (pixels 0..N-1,
    samples 0..3) with the fog budget, both past the pixel jitter."""
    k = tsampler.max_pairs_per_sample(max_bounces, nee_on, True)
    pix = np.arange(N)
    smp = np.arange(N) % 4
    t = tsampler.ThreefrySampler(seed, 0, _t(pix), _t(smp), k)
    j = jsampler.ThreefrySampler(seed, 0, _j(pix.astype(np.uint32)),
                                 _j(smp.astype(np.uint32)), k)
    t.draw2()
    with jax.disable_jit():
        j.draw2()
    return t, j


def _log_agrees(u: np.ndarray) -> np.ndarray:
    with jax.disable_jit():
        jl = np.asarray(jnp.log(_j(u)))
    return torch.log(_t(u)).numpy() == jl


def test_fog_collision_matches_jax():
    """The collision draw, t_fog = -log(u) float32(1 / sigma) and the
    decision against the hit's t (or the sky shell on a miss): the draws
    bit-equal, t_fog bit-equal where torch's and XLA's log agree (2 ulps
    elsewhere), the decisions equal wherever the t_fog are; a third of the
    lanes miss. torch's and XLA's CPU float32 log agree on 85.4% of these
    lanes (ROADMAP Queue 3 #13's cause; measured here)."""
    cfg = RenderConfig(fog_density=SIGMA, fog_albedo=0.8).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    gen = np.random.Generator(np.random.PCG64(11))
    hit_t = (gen.random(N) * 3000.0).astype(np.float32)
    hit_t[gen.random(N) < 0.33] = -1.0
    mask = gen.random(N) < 0.8
    ts, js = _samplers()
    got_m, got_t = pathtrace._fog_collision(cfg, ts, _t(mask), _t(hit_t))
    with jax.disable_jit():
        want_m, want_t = jpathtrace._fog_collision(jcfg, js, _j(mask),
                                                   _j(hit_t))
    ts2, _ = _samplers()
    u = ts2.draw1().numpy()
    agree = _log_agrees(u)
    assert agree.mean() > 0.8
    got_t, want_t = _np(got_t), _np(want_t)
    np.testing.assert_array_equal(got_t[agree], want_t[agree])
    assert _ulps(got_t, want_t).max() <= 2
    same = got_t == want_t
    np.testing.assert_array_equal(_np(got_m)[same], _np(want_m)[same])
    collided = _np(want_m)
    assert 0.2 < collided.mean() < 0.8
    assert not collided[~mask].any()


def _scatter_lanes(seed=23):
    """Vertices on the default spheres' surfaces, hit along bd from an
    origin, with half the lanes fog collisions at t_fog < t (their vertex
    base the same origin), throughput, colour, prev_pdf and emission_ok."""
    cfg = RenderConfig().validate()
    jsc = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    gen = np.random.Generator(np.random.PCG64(seed))
    idx = gen.integers(0, 128, N)
    idx[idx % 16 == 0] += 1
    c = np.stack([np.asarray(a) for a in (jsc.center_x, jsc.center_y,
                                          jsc.center_z)]).astype(np.float64)
    r = np.sqrt(np.asarray(jsc.sqr_radius, np.float64))
    nv = gen.normal(size=(3, N))
    nv /= np.linalg.norm(nv, axis=0)
    h = c[:, idx] + nv * r[idx]
    o = h + nv * (5.0 + 50.0 * gen.random(N))
    d = h - o
    t = np.linalg.norm(d, axis=0)
    d /= t
    medium = gen.random(N) < 0.5
    t = np.where(medium, t * gen.random(N), t)
    f = np.float32
    return jsc, dict(o=o.astype(f), d=d.astype(f), t=t.astype(f),
                     n=nv.astype(f), index=idx.astype(np.int32),
                     medium=medium, tp=gen.random((3, N)).astype(f),
                     col=gen.random((3, N)).astype(f),
                     pdf=gen.random(N).astype(f),
                     eo=gen.integers(0, 3, N).astype(np.int32))


@pytest.mark.parametrize("mode", ["procedural", "microfacet"])
@pytest.mark.parametrize("kw", [{}, {"nee": True},
                                {"nee": True, "mis": True}],
                         ids=["bsdf", "nee", "mis"])
def test_fog_vertex_scatter_matches_jax(mode, kw):
    """_scatter_and_roulette with half the lanes fog vertices: the fog
    lanes' isotropic direction (sqrt(1 - mz^2) (cos, sin)(2 pi u2), mz = 1 -
    2 u1, from the pair the surface lanes take) bit-equal where sin/cos of 2
    pi u2 agree, their throughput fog_albedo tp bit-equal, roulette and the
    continuation origin; the surface lanes as before; the NEE and light
    terms only at surface lanes (a fog lane's colour unchanged); and
    emission_ok: 0 after a surface vertex without MIS, 1 after a fog one;
    under MIS 1 and 2; kept without NEE."""
    cfg = RenderConfig(material_mode=mode, fog_density=SIGMA,
                       fog_albedo=0.7, **kw).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    jsc, ln = _scatter_lanes()
    sc = SphereScene.from_numpy(jsc.center_x, jsc.center_y, jsc.center_z,
                                jsc.sqr_radius).with_tables(
        *_jax_tables(128))
    spheres = sc.packed()
    ts, js = _samplers(2, cfg.nee)
    jisect, _, jls, _ = jmake_intersector(jcfg, jsc)
    use_nee = cfg.nee
    with jax.disable_jit():
        want = jpathtrace._scatter_and_roulette(
            jcfg, jisect, js, jls if use_nee else None, use_nee, cfg.mis, 0,
            *map(_j, ln["o"]), *map(_j, ln["d"]), _j(ln["t"]),
            *map(_j, ln["n"]),
            _j(np.where(ln["medium"], 1, ln["index"]).astype(np.int32)),
            _j(np.ones(N, bool)), *map(_j, ln["tp"]), *map(_j, ln["col"]),
            _j(ln["pdf"]), _j(ln["eo"]), medium=_j(ln["medium"]))
    sampler = nee.sphere_light_sampler(cfg, spheres) if use_nee else None
    got = pathtrace._scatter_and_roulette(
        cfg, spheres[4:].T, ts, tuple(map(_t, ln["o"])),
        tuple(map(_t, ln["d"])), _t(ln["t"]), tuple(map(_t, ln["n"])),
        _t(ln["index"]), torch.ones(N, dtype=torch.bool),
        tuple(map(_t, ln["tp"])), tuple(map(_t, ln["col"])),
        sphere_intersector(*spheres[:4]), None, 0, sampler, _t(ln["pdf"]),
        _t(ln["eo"]), _t(ln["medium"]))
    _, bd, tp, col, survive, cast_o, _, eo = got
    (_, _, _, wdx, wdy, wdz, wtr, wtg, wtb, wcr, wcg, wcb, _, weo, wsurv,
     wcx, wcy, wcz) = map(_np, want)
    med = ln["medium"]
    u = _samplers(2, cfg.nee)[0].draw2()[1].numpy()  # the pair's u2
    agree = _trig_agrees(((2.0 * math.pi) * _t(u)).numpy())
    assert agree.mean() > 0.85
    fog_dir = med & agree
    for g, w in zip(bd, (wdx, wdy, wdz)):
        np.testing.assert_array_equal(_np(g)[fog_dir], w[fog_dir])
    for g, w, t0 in zip(tp, (wtr, wtg, wtb), ln["tp"]):
        np.testing.assert_array_equal(_np(g)[med], w[med])
    np.testing.assert_array_equal(_np(survive)[med], wsurv[med])
    for g, w in zip(cast_o, (wcx, wcy, wcz)):
        np.testing.assert_array_equal(_np(g)[fog_dir], w[fog_dir])
    for g, c0 in zip(col, ln["col"]):  # no NEE, no light at fog lanes
        np.testing.assert_array_equal(_np(g)[med], c0[med])
    np.testing.assert_array_equal(_np(eo), weo)
    if cfg.nee and not cfg.mis:
        assert set(np.unique(weo[med])) == {1} and not weo[~med].any()
    elif cfg.mis:
        assert (weo[med] == 2).all() and (weo[~med] == 1).all()
    else:
        np.testing.assert_array_equal(weo, ln["eo"])
    # the fog lanes' direction is a unit vector, isotropic in z
    dz = _np(bd[2])[med]
    assert abs(dz.mean()) < 0.05 and dz.min() < -0.9 and dz.max() > 0.9
    assert 0.2 < _np(survive)[med].mean() < 0.9


def test_full_weight_after_fog_vertex_matches_jax():
    """_resolve_vertex under NEE with MIS and fog: emission found by a ray
    that left a fog vertex (emission_ok 2) keeps its full weight, the rest
    the balance weight; fog lanes never emit. Bit-equal (no
    transcendental)."""
    cfg = RenderConfig(nee=True, mis=True, fog_density=SIGMA).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    jsc = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    sc = SphereScene.from_numpy(jsc.center_x, jsc.center_y, jsc.center_z,
                                jsc.sqr_radius)
    gen = np.random.Generator(np.random.PCG64(31))
    index = (gen.integers(0, 8, N) * 16).astype(np.int32)  # every one a light
    medium = gen.random(N) < 0.3
    eo = np.where(gen.random(N) < 0.5, 2, 1).astype(np.int32)
    bd = gen.normal(size=(3, N))
    bd = (bd / np.linalg.norm(bd, axis=0)).astype(np.float32)
    n = -bd + gen.normal(size=(3, N)).astype(np.float32) * 0.3
    t = (gen.random(N) * 300.0).astype(np.float32)
    r2 = np.asarray(jsc.sqr_radius)[index]
    tp = gen.random((3, N)).astype(np.float32)
    col = gen.random((3, N)).astype(np.float32)
    pdf = gen.random(N).astype(np.float32)
    dist = t.copy()
    jisect, _, jls, _ = jmake_intersector(jcfg, jsc)
    with jax.disable_jit():
        want = jpathtrace._resolve_vertex(
            jcfg, jls, True, True, _j(dist), *map(_j, bd), _j(t),
            *map(_j, n), _j(np.where(medium, 1, index).astype(np.int32)),
            _j(r2), _j(r2), *map(_j, tp), *map(_j, col), _j(pdf), _j(eo))
    hit = pathtrace.Hit(t=_t(t), nx=_t(n[0]), ny=_t(n[1]), nz=_t(n[2]),
                        index=_t(index), emis_r2=_t(r2))
    got = pathtrace._resolve_vertex(
        cfg, _t(dist), tuple(map(_t, bd)), hit, tuple(map(_t, tp)),
        tuple(map(_t, col)), nee.sphere_light_sampler(cfg, sc.packed()),
        _t(pdf), _t(eo), _t(medium))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    for g, w in zip(got[2], want[2:]):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert (_np(got[0])[medium] >= 0).all() and _np(got[1])[medium].all()
    full = ~medium & (eo == 2)
    emit = _np(pathtrace._emit_term(cfg, _t(r2)))
    np.testing.assert_array_equal(_np(got[2][0])[full],
                                  (col[0] + tp[0] * emit)[full])


def test_lights_transmittance_matches_jax():
    """explicit_light_contribution under fog: a point light's term times
    exp(-sigma dist), a directional light's times float32(exp(-sigma sky))
    computed once on the host in float64 (ops/fog.py, the same float as the
    JAX package's), against the JAX function at 4096 vertices on the
    default spheres: bit-equal where torch's and XLA's exp of the point
    light's -sigma dist agree, within 4 ulps elsewhere (an ulp of exp
    through the products after it), and below the clear-air terms wherever
    lit."""
    cfg = RenderConfig(sphere_count=128, fog_density=SIGMA).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    assert fog_directional_transmittance(cfg) == float(np.float32(
        np.exp(-SIGMA * 4.0 * cfg.world_size)))
    jsc = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    sc = SphereScene.from_numpy(jsc.center_x, jsc.center_y, jsc.center_z,
                                jsc.sqr_radius)
    gen = np.random.Generator(np.random.PCG64(51))
    idx = gen.integers(0, 128, N)
    nv = gen.normal(size=(3, N))
    nv /= np.linalg.norm(nv, axis=0)
    c = np.stack([np.asarray(a) for a in (jsc.center_x, jsc.center_y,
                                          jsc.center_z)]).astype(np.float64)
    r = np.sqrt(np.asarray(jsc.sqr_radius, np.float64))
    h = (c[:, idx] + nv * r[idx]).astype(np.float32)
    nv = nv.astype(np.float32)
    kd, tp = (gen.random((3, N), dtype=np.float32) for _ in range(2))
    bufs = (jmaterials.PhongMaterials.from_arrays(
        np.array([[0.9, 0.2, 0.1, 1.0]], np.float32),
        np.zeros((1, 3), np.float32), np.zeros(1, np.float32)),
        jmaterials.PointLights.from_arrays(
            np.zeros((1, 3), np.float32),
            np.array([[5e7, 4e7, 3e7]], np.float32)),
        jmaterials.DirectionalLights.from_arrays(
            np.array([[0.3, -1.0, 0.2]], np.float32),
            np.array([[0.5, 0.5, 0.6]], np.float32)))
    port = ExplicitLights(*(c.carry_across(b) for c, b in zip(
        (materials.PhongMaterials, materials.PointLights,
         materials.DirectionalLights), bufs)))
    t = [tuple(_t(a[i]) for i in range(3)) for a in (h, nv, kd, tp)]
    with jax.disable_jit():
        want = jexplicit_light_contribution(
            jcfg, JExplicitLights(*bufs), jsphere_intersector(jsc),
            *map(_j, h), *map(_j, nv), *map(_j, kd), *map(_j, tp))
    isect = sphere_intersector(*sc.packed()[:4])
    got = torch.stack(explicit_light_contribution(cfg, port, isect,
                                                  *t)).numpy()
    want = np.stack([_np(w) for w in want])
    lx, ly, lz = (-x for x in t[0])  # the point light sits at the origin
    arg = -SIGMA * torch.sqrt((lx * lx + ly * ly + lz * lz).double()).float()
    with jax.disable_jit():
        agree = torch.exp(arg).numpy() == np.asarray(jnp.exp(_j(arg)))
    assert agree.mean() > 0.8
    np.testing.assert_array_equal(got[:, agree], want[:, agree])
    assert _ulps(got, want).max() <= 4
    clear = torch.stack(explicit_light_contribution(
        cfg.replace(fog_density=0.0), port, isect, *t)).numpy()
    lit = want.max(0) > 0
    assert 0.1 < lit.mean() < 0.9
    assert (got[:, lit] < clear[:, lit]).all()


@pytest.mark.parametrize("max_bounces", [1, 2, 4])
@pytest.mark.parametrize("nee_on", [False, True], ids=["off", "nee"])
def test_draw_budget_matches_jax(max_bounces, nee_on):
    """K with fog = the JAX package's max_pairs_per_sample(mb, nee, fog) at
    every site of the port: the plain step's samplers (for the path tracer
    and the AO AOV alike, as the JAX package budgets fog whatever the AOV),
    the kernels' parameter block (ip[8], and the fog flag ip[23]) and the
    wavefront passes' (config_max_pairs)."""
    want = jsampler.max_pairs_per_sample(max_bounces, nee_on, True)
    assert want == 2 + (4 if nee_on else 2) * max_bounces + max_bounces + 1
    for aov in ("pathtracing", "ambient_occlusion"):
        cfg = RenderConfig(width=128, height=64, max_bounces=max_bounces,
                           nee=nee_on, aov=aov,
                           fog_density=SIGMA).validate()
        assert tsampler.config_max_pairs(cfg) == want
        ip, fp = common.step_params(cfg, 1, 16,
                                    Camera.from_config(cfg).packed())
        assert ip[8] == want and ip[23] == 1
        assert fp[51] == np.float32(SIGMA)
        assert fp[52] == np.float32(1.0 / SIGMA)
        flat = torch.arange(4)
        s = next(common._sample_samplers(cfg, flat, flat, None))
        assert s._max_pairs == want
        clear = cfg.replace(fog_density=0.0)
        assert common.step_params(clear, 1, 16, np.zeros(
            (10, 4), np.float32))[0][23] == 0


def test_ambient_occlusion_budget_matches_xla_oracle():
    """The AO AOV with fog draws at the fog budget's counters, as the JAX
    package's does: the plain step against the oracle's, 2 spp, op by op
    (bit-equal accum[3], the north star's gates), and unlike the AO render
    without fog at sample 1."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, aov="ambient_occlusion",
                       spp_per_step=2, fog_density=SIGMA).validate()
    ta, ja = _parity(cfg, 1, 0.05)
    clear = _port_render(cfg.replace(fog_density=0.0), 1)
    assert (np.abs(ta[:3] - clear[:3]).max(0) > 0).mean() > 0.005


# ---------------------------------------------------------------------------
# tests/test_fog.py's closed forms and agreements on the port's plain path
# ---------------------------------------------------------------------------

def _rows(centres, radii):
    c = np.atleast_2d(np.asarray(centres, np.float32))
    r = np.asarray(radii, np.float32).reshape(-1)
    return np.stack([c[:, 0], c[:, 1], c[:, 2], r * r]).astype(np.float32)


EMISSIVE = ((0.0, 0.0, -300.0), 80.0)  # tests/test_fog.py emissive_scene
GALLERY = (((0.0, 500.0, -300.0), (0.0, 0.0, -1.03e4)),
           (120.0, 1e4 - 100.0))  # a big light over a giant floor
BEHIND = ((0.0, 0.0, 400.0), 150.0)  # a light behind the camera


@functools.cache
def _trace(scene, n, **kw):
    """tests/test_fog.py::trace_rays on the port: n rays from (0, 0, 10)
    down -z, one sample each, no sky unless asked; the mean red radiance."""
    rows = _t(_rows(*scene))
    args = dict(width=8, height=8, env_mode="none", world_size=1024.0)
    args.update(kw)
    cfg = RenderConfig(**args).validate()
    fog = cfg.fog_density > 0.0
    sampler = tsampler.ThreefrySampler(
        cfg.seed, 0, torch.arange(n), torch.zeros(n, dtype=torch.int64),
        tsampler.max_pairs_per_sample(cfg.max_bounces, cfg.nee, fog))
    z = torch.zeros(n)
    n_obj = rows.shape[1]
    albedo = _t(np.stack([np.asarray(c) for c in jprocedural_color(
        jnp.arange(max(n_obj, 2)))], 1))
    lights = (nee.LightSampler("area", rows, cfg.emissive_every)
              if cfg.nee else None)
    r, _, _ = pathtrace.trace_path(
        cfg, sphere_intersector(*rows), sphere_anyhit(*rows), albedo,
        sampler, z, z, torch.full((n,), 10.0), z, z, torch.full((n,), -1.0),
        nee=lights)
    return float(r.double().mean())


@pytest.mark.parametrize("sigma", [0.002, 0.01])
def test_absorbing_fog_attenuates_exponentially(sigma):
    clear = _trace(EMISSIVE, 200_000, max_bounces=2)
    foggy = _trace(EMISSIVE, 200_000, max_bounces=2, fog_density=sigma,
                   fog_albedo=0.0)
    t_hit = (300.0 + 10.0) - 80.0
    assert foggy == pytest.approx(clear * math.exp(-sigma * t_hit), rel=0.02)


def test_scattering_fog_keeps_more_energy():
    clear = _trace(EMISSIVE, 100_000, max_bounces=4)
    absorb = _trace(EMISSIVE, 100_000, max_bounces=4, fog_density=0.004,
                    fog_albedo=0.0)
    scatter = _trace(EMISSIVE, 100_000, max_bounces=4, fog_density=0.004,
                     fog_albedo=1.0)
    assert absorb < scatter < clear * 1.05


def test_sky_attenuates_too():
    """Only collision-free flights to the sky shell see the sky (every ray
    misses the one sphere, far off their axis)."""
    far = ((1e7, 0.0, 0.0), 1.0)
    clear = _trace(far, 200_000, max_bounces=2, env_mode="sun")
    assert clear > 0.0
    foggy = _trace(far, 200_000, max_bounces=2, env_mode="sun",
                   fog_density=0.001, fog_albedo=0.0, fog_sky_distance=1500.0)
    assert foggy == pytest.approx(clear * math.exp(-0.001 * 1500.0),
                                  rel=0.05)


FOG_GALLERY = dict(max_bounces=3, fog_density=0.0008, fog_albedo=0.7)


def test_nee_agrees_with_bsdf_only_under_fog():
    plain = _trace(GALLERY, 200_000, **FOG_GALLERY)
    with_nee = _trace(GALLERY, 200_000, nee=True, **FOG_GALLERY)
    assert with_nee == pytest.approx(plain, rel=0.05)


def test_mis_agrees_with_bsdf_and_nee_under_fog():
    plain = _trace(GALLERY, 200_000, **FOG_GALLERY)
    with_nee = _trace(GALLERY, 200_000, nee=True, **FOG_GALLERY)
    with_mis = _trace(GALLERY, 200_000, nee=True, mis=True, **FOG_GALLERY)
    assert with_mis == pytest.approx(plain, rel=0.05)
    assert with_mis == pytest.approx(with_nee, rel=0.05)


def test_full_weight_after_fog_vertex():
    """Every photon that arrives was scattered at a fog vertex first (the
    light is behind the camera, no floor): MIS must find those paths with
    full weight."""
    kw = dict(max_bounces=3, fog_density=0.002, fog_albedo=1.0)
    plain = _trace(BEHIND, 300_000, **kw)
    with_mis = _trace(BEHIND, 300_000, nee=True, mis=True, **kw)
    assert plain > 0.0
    assert with_mis == pytest.approx(plain, rel=0.08)


def test_fog_off_is_bit_identical():
    """fog_density 0 changes nothing, whatever fog_albedo: the plain step
    draws no collision and keeps the budget."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, nee=True, mis=True).validate()
    a = _port_render(cfg, 2)
    b = _port_render(cfg.replace(fog_albedo=0.33), 2)
    np.testing.assert_array_equal(a, b)
    assert (a[:3].max(0) > 0).mean() > 0.05


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

def _view(cfg):
    """From 4 radii off the diffuse sphere nearest to an emissive one,
    toward that light (spheres); up close at the diffuse mesh 1 from the
    side of the light mesh 0 (meshes): tests/test_torch_nee.py's views."""
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


def _zero_state(cfg):
    z = np.zeros((4, cfg.padded_height, cfg.padded_width), np.float32)
    return z, z[:3].copy()


@functools.cache
def _oracle(cfg_json: str, steps: int):
    """The JAX oracle's accum and output after `steps` op-by-op steps from
    zero: once per module and configuration."""
    cfg = RenderConfig.from_json(cfg_json)
    jcfg = JRenderConfig.from_json(cfg_json)
    jscene, _ = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    jstep = jbuild(jcfg, jscene, backend="xla")
    jst = jinit(jcfg)
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    return np.asarray(jst.accum), np.asarray(jst.output)


def _port_render(cfg, steps, counts=None):
    """The port's plain step's accum (and output with `counts`, the fog
    collisions it counted into that dict) after `steps` steps from zero."""
    _, scene = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    st = FrameState.from_numpy(*_zero_state(cfg))
    with pathtrace.count_fog_collisions() as c:
        for _ in range(steps):
            st = step(st, cam)
    if counts is None:
        return st.accum.numpy()
    counts.update(c)
    return st.accum.numpy(), st.output.numpy()


def _parity(cfg, steps: int, min_lit: float, min_collided: float = 0.0):
    """The port's plain step against the oracle's render of the same
    configuration: the north star's gates, lit coverage and the share of
    samples with a fog collision. Returns (port accum, oracle accum)."""
    ja, jo = _oracle(cfg.to_json(), steps)
    counts = {}
    ta, to = _port_render(cfg, steps, counts)
    lit = (np.abs(ja[:3, :cfg.height, :cfg.width]).max(0) > 0).mean()
    assert lit > min_lit, f"lit coverage {lit}"
    if min_collided:
        share = counts["collided"] / counts["samples"]
        assert share > min_collided, f"collision share {share}"
    np.testing.assert_array_equal(ta[3], ja[3])
    rmse = np.sqrt(((ta - ja) ** 2).mean())
    assert rmse < 1e-3, f"port/oracle RMSE {rmse}"
    flips = (np.abs(to - jo) > 1e-3).mean()
    assert flips < 2e-3, f"flips {flips}"
    return ta, ja


SPHERE_CFG = RenderConfig(width=64, height=32, tile_width=64, tile_height=32,
                          sphere_count=32, env_mode="none",
                          fog_density=0.01, fog_albedo=0.8)
TRI_CFG = RenderConfig(width=64, height=32, tile_width=64, tile_height=32,
                       sphere_count=4, disc_lat=4, disc_long=4,
                       scene_kind="triangle", env_mode="none",
                       emissive_every=2, fog_density=0.01, fog_albedo=0.8)


@pytest.mark.parametrize("kw", [
    pytest.param({"max_bounces": 1}, id="fog_one_bounce"),
    pytest.param({}, id="fog"),
    pytest.param({"nee": True}, id="fog_nee"),
    pytest.param({"nee": True, "mis": True}, id="fog_nee_mis")])
def test_sphere_step_matches_xla_oracle(kw):
    _parity(SPHERE_CFG.replace(**kw).validate(), 2, 0.05, 0.05)


def test_triangle_step_matches_xla_oracle():
    """One step of two bounces with NEE and MIS: the JAX triangle oracle op
    by op sweeps every triangle in Python."""
    _parity(TRI_CFG.replace(nee=True, mis=True).validate(), 1, 0.05, 0.05)


def test_fog_configs_raise_the_jax_errors():
    """tests/test_fog.py::TestParity::test_validation: fog with a stateful
    sampler, with emissive_every 1 and with the wavefront step raise the
    config's ValueError (the JAX config's), and so does the wavefront pass
    given a fog config; fog + nee (+ mis) validate and build."""
    for kw, match in (({"rng": "tinymt"}, "stateless"),
                      ({"emissive_every": 1}, "emissive_every"),
                      ({"wavefront": True}, "wavefront")):
        with pytest.raises(ValueError, match=match):
            RenderConfig(fog_density=0.1, **kw).validate()
        with pytest.raises(ValueError, match=match):
            JRenderConfig(fog_density=0.1, **kw).validate()
        with pytest.raises(ValueError, match=match):
            build_render_step(RenderConfig(width=128, height=64,
                                           sphere_count=16, fog_density=0.1,
                                           **kw), compute_spheres(16),
                              backend="torch")
    from l2n_tpu_torch.ops.kernels.wavefront import wavefront_pass_a
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       fog_density=0.1).validate()
    with pytest.raises(ValueError, match="wavefront"):
        wavefront_pass_a(cfg, torch.zeros((1, 2), dtype=torch.int32),
                         Camera.from_config(cfg).packed(),
                         compute_spheres(16).packed(),
                         torch.zeros((4, 64, 128)))
    for kw in ({"nee": True}, {"nee": True, "mis": True}):
        build_render_step(RenderConfig(width=128, height=64, sphere_count=16,
                                       fog_density=0.1, **kw),
                          compute_spheres(16), backend="torch")
